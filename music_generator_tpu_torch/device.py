"""Device selection and float32 discipline for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU: a missing card
is an error, never a quiet fall-back, so a run that claims the GPU path
cannot silently measure the CPU one."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device, "cuda" when None.  Raises RuntimeError
    when CUDA is asked for (explicitly or by default) and no card exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev


def full_f32() -> None:
    """Run float32 math in full float32 on the card: no TF32 in matmuls
    AND none in cuDNN convolutions (cuDNN defaults to TF32).  The JAX
    reference generates at float32 with "highest" matmul precision
    (config.py gen_matmul_precision), and TF32's 10-bit mantissa would move
    probabilities enough to flip Bernoulli draws."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def bf16_f32_sums(on: bool = True) -> Iterator[None]:
    """Inside the block, bfloat16 matmuls on the card sum their products in
    float32 and round once, as XLA's bfloat16 dots do (cuBLAS's reduced
    precision reduction off; PyTorch allows it by default).  The setting
    before the block is restored on exit, so it reaches no later work of
    the process.  `on=False` leaves the setting alone."""
    if not on:
        yield
        return
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
