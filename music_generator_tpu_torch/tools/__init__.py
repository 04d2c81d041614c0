"""The port's verification tools, run on the card (`--device cpu` runs them
on the CPU through the plain versions):

    python -m music_generator_tpu_torch.tools.validate_lstm2
    python -m music_generator_tpu_torch.tools.validate_biax [--gates G]
    python -m music_generator_tpu_torch.tools.check_fidelity [--out DIR]

and the Keras 2 export, a file conversion on the host:

    python -m music_generator_tpu_torch.tools.export_keras [--out H5]
"""
