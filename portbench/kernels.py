"""The port's hand-written CUDA kernels, by the names the profiler shows
(the `__global__` functions of `music_generator_tpu_torch/csrc/`), and
the device time a traced window spent in them."""

from __future__ import annotations

import re

# csrc/biax_passes.cuh and csrc/biax_common.cuh: the bulk products,
# scans and weight-gradient reductions that the biaxial stacks (kernels
# 2-5), the fused two-layer stack (6-7) and the recurrence (8-9) share.
SHARED = ("gemm_mma_kernel", "gemm_fma_kernel", "scan_streamed_kernel",
          "scan_cluster_kernel", "fwd_scan_streamed_kernel",
          "fwd_scan_cluster_kernel", "wgrad_partial_kernel",
          "wgrad_mma_kernel", "colsum_partial_kernel", "wgrad_sum_kernel")
BIAX = ("time_prologue_kernel", "time_ds_kernel", "note_prologue_kernel",
        "note_heads_kernel", "note_ds_kernel") + SHARED
LSTM2 = ("stack_prologue_kernel",) + SHARED
NOTEGEN = ("notegen_cluster_kernel", "notegen_streamed_kernel")


def matcher(names):
    """A test of a profiler kernel name: is it one of `names` (the
    function's own identifier, before its template or argument list)?"""
    pat = re.compile(r"(?:^|[\s:*&])(" + "|".join(map(re.escape, names))
                     + r")\s*[<(]")
    return lambda kernel: pat.search(kernel) is not None


def device_s(run, names):
    """(seconds, launches) of the traced window in the kernels `names`;
    None when the run has no trace or the trace shows none of them."""
    if run.profile is None:
        return None
    s, n = run.profile.device_s(matcher(names))
    return (s, n) if n else None
