"""The lstm2 mask dump (music_generator_tpu_torch/ops/lstm2.py::dump_masks,
the counterpart of the JAX package's tools/tpu_validate_lstm2.py
`extract_masks`) on the CPU.

On a CPU device the wrapper is its plain version, `stack_masks`: the same
tensor, no launch, None at dropout 0; on a CUDA device it launches
csrc/lstm2_masks.cu or raises.  The kernel itself runs only on the card
(chip_smoke.py phase 2 holds it to `stack_masks` with torch.equal).  The
JAX `extract_masks` cannot run here: it draws the TPU's hardware-PRNG bits,
which the Pallas interpreter does not provide (tests/test_pallas_lstm2.py);
the port's mask is its own Murmur3 function, so the masks are held to their
own definition here and the stack that applies them to the JAX rebuild in
tests/test_torch_validate.py.
"""

import os
import re

import pytest
import torch

from music_generator_tpu_torch.ops import lstm2
from music_generator_tpu_torch.ops.biax import _keep_scale

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "music_generator_tpu_torch", "csrc")


@pytest.mark.parametrize("S,R,H", [(4, 16, 8), (3, 7, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dump_masks_on_cpu_is_stack_masks(S, R, H, dtype, p):
    before = lstm2.dump_masks.launches
    got = lstm2.dump_masks(11, S, R, H, p, dtype, "cpu")
    want = lstm2.stack_masks(11, S, R, H, 1.0 - p, dtype)
    assert got.dtype == dtype and got.shape == (S, R, H)
    assert torch.equal(got, want)
    assert lstm2.dump_masks.launches == before
    # Kept elements are 1/keep rounded to the dtype, the rest 0.
    scale = _keep_scale(1.0 - p, dtype)
    assert set(got.float().unique().tolist()) <= {0.0, scale}


def test_dump_masks_is_the_mask_the_stack_applies():
    """Each step's slice is keep_mask of the whole row space at that step,
    the function lstm2_stack_reference (and csrc/lstm2.cu) applies; a
    different seed gives different masks."""
    S, R, H = 3, 10, 6
    got = lstm2.dump_masks(5, S, R, H, 0.5, torch.float32)
    rows = torch.arange(R, dtype=torch.int64)
    for t in range(S):
        assert torch.equal(got[t], lstm2.keep_mask(5, t, rows, H, 0.5,
                                                   torch.float32))
    assert not torch.equal(got, lstm2.dump_masks(6, S, R, H, 0.5))


def test_dump_masks_at_dropout_zero_is_none():
    before = lstm2.dump_masks.launches
    assert lstm2.dump_masks(1, 4, 8, 8, 0.0) is None
    assert lstm2.stack_masks(1, 4, 8, 8, 1.0, torch.float32) is None
    assert lstm2.dump_masks.launches == before


def test_dump_masks_never_falls_back_off_the_cpu():
    """A CUDA device launches the kernel or raises: without a card the call
    fails instead of returning the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py checks the kernel")
    before = lstm2.dump_masks.launches
    with pytest.raises((RuntimeError, AssertionError)):
        lstm2.dump_masks(1, 2, 4, 4, 0.5, torch.float32, "cuda")
    assert lstm2.dump_masks.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        lstm2.dump_masks(1, 2, 4, 4, 0.5, torch.float32, "meta")


def test_the_kernel_source_uses_the_stacks_mask_function():
    """csrc/lstm2_masks.cu writes `mval` of biax_common.cuh at the stack's
    site, the call csrc/lstm2.cu makes, and the site number is the one
    ops/lstm2.py hashes."""
    header = open(os.path.join(CSRC, "biax_common.cuh")).read()
    site = re.search(r"S_STACK_MID = (\d+)", header)
    assert site and int(site.group(1)) == lstm2.S_STACK_MID
    dump = open(os.path.join(CSRC, "lstm2_masks.cu")).read()
    stack = open(os.path.join(CSRC, "lstm2.cu")).read()
    assert '#include "biax_common.cuh"' in dump
    call = "mval(drop, S_STACK_MID, 0, t, g, H, j)"
    assert call in dump and call in stack
    # No second copy of the hash: its constants live in the header only.
    assert "0x85EBCA6B" in header and "0x85EBCA6B" not in dump
