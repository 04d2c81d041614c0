"""`python -m music_generator_tpu_torch.serve [--device cpu] [--params NPZ]
...`: serve generation over HTTP with the PyTorch port (see
serving/server.py::serve_main)."""

from music_generator_tpu_torch.serving.server import serve_main

if __name__ == "__main__":
    serve_main()
