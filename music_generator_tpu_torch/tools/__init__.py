"""The port's verification tools, run on the card (`--device cpu` runs them
on the CPU through the plain versions):

    python -m music_generator_tpu_torch.tools.validate_lstm2
    python -m music_generator_tpu_torch.tools.validate_biax [--gates G]
    python -m music_generator_tpu_torch.tools.check_fidelity [--out DIR]

the Keras 2 export, a file conversion on the host:

    python -m music_generator_tpu_torch.tools.export_keras [--out H5]

and one rank of a data-parallel run, which the tests and chip_smoke.py
start two at a time:

    python -m music_generator_tpu_torch.tools.mp_worker RANK WORLD PORT OUT
        step,fit,generate,serve [--device D] [--backend gloo|nccl]
"""
