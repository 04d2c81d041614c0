// The single-layer LSTM recurrence over a precomputed input projection as
// CUDA kernels for Hopper (sm_90a): forward and backward of one layer
// scanning S steps over R rows, z = xw_t + (h_{t-1} U -> T).
//
// Replaces music_generator_tpu/ops/pallas_lstm.py: `_forward_impl` (kernel
// `_fwd_kernel`) and `_bwd_rule` (kernel `_bwd_kernel`, custom VJP
// `_make_recurrence`).  xw = x W + b comes in already projected, in the
// compute dtype T (ops/lstm.py::lstm_scan).  The forward writes hs and the
// previous-c tape cs in T (cs only when the caller will differentiate) and
// the terminal h_T (not rounded) and c_T in float32.
//
// What bounds it on this card.  At the flagship shapes the time axis runs
// S = 128, R = 768, H = 256 and the note axis S = 48, R = 2048, H = 128.  A
// forward does 2 S R H 4H + 10 S R 4H operations (the Pallas CostEstimate):
// 52 GFLOP on the time axis, 0.05 ms at 989 TFLOP/s bf16; it moves about
// S R (4H + 2H) values, 151 MB in bf16, 0.045 ms at 3.35 TB/s.  The backward
// does 3x the products.  The real floor is the chain of S dependent steps,
// each a product with all of U (512 KB bf16 on the time axis, 128 KB on the
// note axis).
//
// Forward: one launch of the biaxial forwards' scan (launch_fwd_scan of
// biax_passes.cuh) with (S, A, B) = (S, R, 1) and its ends set (FwdEnds):
// h0 rounded to T is h[-1], so the product runs at s = 0 too; c is seeded
// from c0; h_T (not rounded) and c_T are written at the last step.  xw takes
// the place of the stacks' input pre-activations.  bfloat16 keeps U's gate
// columns resident in a thread-block cluster (4 blocks at H = 256, one at
// H = 128), each step one product from shared memory and h exchanged
// through distributed shared memory into double-buffered tiles, one cluster
// barrier a step; float32 streams U from L2 at every step.
//
// Backward, as passes on the machinery of biax_passes.cuh with (S, A, B) =
// (S, R, 1).  Of the two products a step of the TPU kernel makes, only
// dh <- dz U^T carries from step to step: the recomputed pre-activations
// read the h_{t-1} tape, so all S R rows are one bulk product.
//   1. z = xw + (hs_prev U -> T), one GEMM (EPI_XW) into the dxw buffer;
//   2. the reversed scan (launch_scan): the cell backward of each step from
//      z and the c_{t-1} tape, dh = (dz U^T) + dhs, dz written over z; dc
//      seeded with the cotangent of c_T, and dh0 = dz_0 U^T and the last dc
//      carry written at its end (ScanEnds).  bfloat16 keeps U resident in a
//      thread-block cluster (4 blocks at H = 256, one at H = 128); float32
//      streams U^T from L2;
//   3. dU = sum_t h_{t-1}^T dz_t, the deterministic reduction biax_wgrad
//      (biax_common.cuh), which also replaces the TPU kernel's VMEM sum
//      across its sequential grid.
// The wrapper forms the tapes before pass 1: hs_prev = [h0 -> T, hs[:-1]]
// and dhs in float32 with the cotangent of h_T added to its last step.

#include "biax_passes.cuh"

// u is the recurrent matrix `_layout(U)` of the compute dtype (see matvec in
// biax_common.cuh): [H][4H] for float32, [4H][padk(H)] for bf16; h0, c0,
// hT, cT are [R][H] float32.  cluster = 1 (bfloat16 only): U resident in a
// thread-block cluster; cluster = 0: streamed.  prof as for the stacks'
// forward scans (may be null).
extern "C" int lstm_rec_fwd(int bf16, int cluster, const void* xw,
                            const void* u, const float* h0, const float* c0,
                            void* hs, void* cs, float* hT, float* cT, int S,
                            int R, int H, int hard, unsigned long long* prof,
                            void* stream) {
  using namespace biax;
  const PassDims d = {S, R, 1, H, 1};
  const FwdEnds ends = {h0, c0, hT, cT};
  return launch_fwd_scan(bf16, cluster, xw, hs, cs, u, d, hard, prof,
                         (cudaStream_t)stream, ends);
}

// The backward's passes, launched in order by ops/recurrence.py::
// lstm_recurrence_bwd.
// 1. z [M][4H] = xw + (hs_prev U -> T) over all M = S R rows (EPI_XW):
// hs_prev [M][H] is the h_{t-1} tape (h0 in its first R rows), u the
// layout of the compute dtype as for lstm_rec_fwd; z must not alias xw.
extern "C" int lstm_rec_bwd_preact(int bf16, const void* hs_prev,
                                   const void* u, const void* xw, void* z,
                                   int M, int H, void* stream) {
  using namespace biax;
  const int H4 = 4 * H;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    const auto op = operand<biax::bf16>(hs_prev, H, 0, H, u, H4);
    EpiArgs<biax::bf16> e = {(biax::bf16*)z};
    e.xw = (const biax::bf16*)xw;
    return gemm<biax::bf16, EPI_XW>(op, op, M, H4, e, st);
  }
  const auto op = operand<float>(hs_prev, H, 0, H, u, H4);
  EpiArgs<float> e = {(float*)z};
  e.xw = (const float*)xw;
  return gemm<float, EPI_XW>(op, op, M, H4, e, st);
}

// 2. The reversed scan over z_dz (z in, dz = dxw out) with the external dh
// dhs [S][R][H] (float32, the cotangent of h_T folded into step S - 1), the
// c_{t-1} tape cs, dc seeded from dcT, and the initial-state gradients dh0,
// dc0 [R][H] written at its end (launch_scan with ScanEnds).  cluster = 1
// (bfloat16 only): u is U [H][4H], resident in a thread-block cluster;
// cluster = 0: u is `_layout(U^T)`, streamed.  prof as for the stacks'
// scans (may be null).
extern "C" int lstm_rec_bwd_scan(int bf16, int cluster, void* z_dz,
                                 const void* cs, const float* dhs,
                                 const void* u, const float* dcT, float* dh0,
                                 float* dc0, int S, int R, int H, int hard,
                                 unsigned long long* prof, void* stream) {
  using namespace biax;
  const PassDims d = {S, R, 1, H, 1};
  const ScanEnds ends = {dcT, dh0, dc0};
  return launch_scan(bf16, cluster, z_dz, cs, nullptr, dhs, u, d, hard, prof,
                     (cudaStream_t)stream, ends);
}
