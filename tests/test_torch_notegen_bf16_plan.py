"""The pitch-loop kernel's plans with 2-byte weights (the bfloat16
instances), pinned on the CPU (music_generator_tpu_torch/ops/notegen.py,
csrc/notegen.cu):

  * `notegen_plan(G, L, 256, 128, 48, 2)` at the flagship widths, depths
    1-8 and G = 3 and 64: the (C, Gc, clusters) of the cluster kernel and
    the shared memory of a block.  The bfloat16 instances write h into the
    same [H][Gp] float32 slots as the float32 instance (the scan flavor's
    two bfloat16 values as one pair in one slot), so the layout, and with
    it every plan, is the one these instances always had;
  * `_smem_bytes` and `notegen_plan` against the C++ they mirror:
    `ng_smem_bytes` and `ng_plan` of csrc/notegen.cu, compiled for the host
    with g++ (their `__host__ __device__` code is plain C++) and called
    through ctypes over a grid of plans, depths, widths and element sizes;
  * tools/notegen_ab.py (another build of csrc/notegen.cu against this
    tree's) stopping where there is no card.

The kernels themselves run only on the card (chip_smoke.py phase 2b).
"""

import ctypes
import re
import shutil
import subprocess

import pytest

from music_generator_tpu_torch.ops import _build, notegen

F, H, N = 256, 128, 48

# notegen_plan(G, L, F, H, N, 2) -> (C, Gc, clusters, smem bytes a block).
PLANS_BF16 = {
    (1, 3): (8, 3, 1, 100736), (1, 64): (8, 8, 8, 150016),
    (2, 3): (8, 3, 1, 117120), (2, 64): (8, 8, 8, 170496),
    (3, 3): (8, 3, 1, 149888), (3, 64): (8, 8, 8, 209408),
    (4, 3): (8, 3, 1, 182656), (4, 64): (8, 4, 16, 182656),
    (5, 3): (8, 3, 1, 216448), (5, 64): (8, 4, 16, 216448),
    (6, 3): (16, 3, 1, 134656), (6, 64): (16, 8, 8, 177280),
    (7, 3): (16, 3, 1, 153088), (7, 64): (16, 8, 8, 197760),
    (8, 3): (16, 3, 1, 171520), (8, 64): (16, 8, 8, 218240),
}


@pytest.mark.parametrize("L, G", sorted(PLANS_BF16))
def test_bf16_plan_at_flagship_widths(L, G):
    plan = notegen.notegen_plan(G, L, F, H, N, 2)
    assert tuple(plan) == PLANS_BF16[(L, G)]
    assert plan.kernel == "cluster"
    assert plan.smem == notegen._smem_bytes(plan.C, plan.Gc, L, N, F, H, 2)
    assert plan.smem <= notegen.SMEM_MAX


# The host-side plan code of csrc/notegen.cu: from NG_SMEM_MAX to the end
# of ng_plan, with entries for ctypes.
_PLAN_CODE = re.compile(r"constexpr int NG_SMEM_MAX.*?\ninline bool ng_plan"
                        r"\(.*?\n}\n", re.S)
_ENTRIES = """
extern "C" long long t_smem(int C, int Gc, int L, int N, int F, int H,
                            int esize) {
  return ng_smem_bytes(C, Gc, L, N, F, H, esize);
}
extern "C" int t_plan(int G, int L, int N, int F, int H, int esize,
                      int* out) {
  NgPlan p;
  if (!ng_plan(G, L, N, F, H, esize, &p)) return 0;
  out[0] = p.C; out[1] = p.Gc; out[2] = p.clusters; out[3] = p.smem;
  return 1;
}
"""


@pytest.fixture(scope="module")
def cpp_plan(tmp_path_factory):
    """csrc/notegen.cu's plan functions built for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build csrc/notegen.cu's plan code for "
                    "the host")
    src = (_build.CSRC / "notegen.cu").read_text()
    m = _PLAN_CODE.search(src)
    assert m, "csrc/notegen.cu: ng_smem_bytes .. ng_plan not found"
    lmax = re.search(r"constexpr int NG_LMAX = (\d+);", src)
    assert lmax and int(lmax.group(1)) == notegen.LMAX
    d = tmp_path_factory.mktemp("ngplan")
    (d / "plan.cc").write_text(
        "#include <algorithm>\n#include <initializer_list>\n"
        "#define __host__\n#define __device__\n"
        f"constexpr int NG_LMAX = {notegen.LMAX};\n"
        + m.group(0) + _ENTRIES)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(d / "libplan.so"), str(d / "plan.cc")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(d / "libplan.so"))
    lib.t_smem.restype = ctypes.c_longlong
    lib.t_smem.argtypes = [ctypes.c_int] * 7
    lib.t_plan.restype = ctypes.c_int
    lib.t_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


# (F, H, N): the flagship widths, test_config()'s, and two odd ones.
WIDTHS = [(256, 128, 48), (32, 16, 48), (20, 24, 12), (96, 64, 30)]


@pytest.mark.parametrize("esize", [2, 4])
def test_smem_bytes_mirrors_ng_smem_bytes(cpp_plan, esize):
    checked = 0
    for F_, H_, N_ in WIDTHS:
        for C in (4, 8, 16):
            if H_ % C:
                continue
            for L in range(1, notegen.LMAX + 1):
                for Gc in range(1, notegen.GC_MAX + 1):
                    want = cpp_plan.t_smem(C, Gc, L, N_, F_, H_, esize)
                    got = notegen._smem_bytes(C, Gc, L, N_, F_, H_, esize)
                    assert got == want, (C, Gc, L, F_, H_, N_, esize)
                    checked += 1
    assert checked > 500


@pytest.mark.parametrize("esize", [2, 4])
def test_notegen_plan_mirrors_ng_plan(cpp_plan, esize):
    out = (ctypes.c_int * 4)()
    for F_, H_, N_ in WIDTHS:
        for L in range(1, notegen.LMAX + 1):
            for G in (1, 2, 3, 5, 8, 9, 17, 64, 256):
                found = cpp_plan.t_plan(G, L, N_, F_, H_, esize,
                                        ctypes.addressof(out))
                try:
                    plan = tuple(notegen.notegen_plan(G, L, F_, H_, N_,
                                                      esize))
                except ValueError:
                    plan = None
                assert plan == (tuple(out) if found else None), (
                    G, L, F_, H_, N_, esize)


def test_notegen_ab_refuses_without_a_card(monkeypatch):
    """tools/notegen_ab.py holds another build of csrc/notegen.cu to this
    tree's on the card: with no card it stops before building anything."""
    from music_generator_tpu_torch.tools import notegen_ab
    monkeypatch.setattr(notegen_ab.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no card"):
        notegen_ab.main(["--other", "parent=notegen.cu"])
