"""Export the port's trained checkpoint as a reference-compatible Keras 2
weights file: the reverse migration path (the JAX package's
`tools/export_keras.py`), written by the port's own HDF5 writer.

Run from the training working directory (where `out/model.pt` lives):

    python -m music_generator_tpu_torch.tools.export_keras --out model.h5
    python -m music_generator_tpu_torch.tools.export_keras \\
        --params artifacts/trained_model_r4/params.npz --out model.h5

A file conversion on the host: the weights are read into a CPU model
(which checks their names and shapes against the config) and written out.
Exits non-zero when there is no checkpoint to export."""

from __future__ import annotations

import argparse

from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.params import load_params_npz
from music_generator_tpu_torch.training.checkpoint import (build_or_load,
                                                           model_path)
from music_generator_tpu_torch.training.keras_import import (
    save_keras_weights)


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="Export weights as a Keras 2 model.h5.")
    parser.add_argument("--out", default="model.h5")
    parser.add_argument("--params", type=str, default=None, metavar="NPZ",
                        help="Export a keystr-layout .npz instead of "
                             "out/model.pt")
    args = parser.parse_args(argv)

    cfg = default_config()
    if args.params:
        model = build_model(cfg, "cpu", state=load_params_npz(args.params))
    else:
        model, loaded = build_or_load(cfg, "cpu")
        if not loaded:
            raise SystemExit(f"no checkpoint found ({model_path(cfg)})")
    save_keras_weights(model.state_dict(), args.out)
    print("wrote", args.out)
    return args.out


if __name__ == "__main__":
    main()
