// One DeepJ axis as a fused two-layer LSTM stack, as CUDA kernels for Hopper
// (sm_90a): forward and backward of two stacked layers scanning S steps over
// R rows, both input projections inside the stack.
//
// Replaces music_generator_tpu/ops/pallas_lstm2.py: `_forward_impl` (kernel
// `_make_fwd_kernel`) and `_bwd_impl` (kernel `_make_bwd_kernel`, custom VJP
// `_make_stack`).  Per step t and row: layer 0 (z = (x0 W0 -> T) + b0 +
// (h U0 -> T)) -> x1 = h0 * mask + s1m in T -> layer 1 (z = (x1 W1 -> T) +
// b1 + (h U1 -> T)) -> hs1.  Tapes hs0, cs0 (the previous c), cs1 in T, only
// when the caller will differentiate; the terminal states in float32 (h not
// rounded).  The cotangent of h0T is not an input of the backward: the TPU
// kernel ignores it too.
//
// The inter-layer mask.  The TPU kernel draws it from the TPU's hardware
// PRNG per (batch tile, step); no other device gives those bits.  Here an
// element (t, row g, unit j) keeps when the Murmur3 finalizer `mval`
// (biax_common.cuh) at site S_STACK_MID, tile 0, step t, row g of the whole
// row space clears the TPU kernel's threshold: a pure function of (seed,
// t, g, j), whatever rows a block owns (ops/lstm2.py::keep_mask is the
// same function in torch).
//
// What bounds it on this card.  At the flagship shapes the time axis runs
// S = 128, R = 768, F = 94, H = 256 and the note axis S = 48, R = 2048,
// F = 259, H = 128.  The forward does 2 S R (F + 3H) 4H + 20 S R 4H
// operations (the Pallas CostEstimate): 174 GFLOP on the time axis, 0.18 ms
// at 989 TFLOP/s bf16, against some 0.06 ms for its bytes at 3.35 TB/s.  The
// backward does 3x the products.  The real floor is the chain of S
// dependent steps, each a product with U (one layer's 512 KB bf16 at the
// time axis, 128 KB at the note axis).
//
// Both directions run as passes on the machinery of biax_passes.cuh with
// (S, A, B) = (S, 1, R): row g of a step is tile 0, row g of `row_pos`, the
// indexing of the mask.
//
// Forward, in six passes, biax_time.cu's with initial and terminal states
// and no style terms.  Of the four products a step of the TPU kernel makes,
// only h0 U0 and h1 U1 carry from step to step: x0 W0 depends on nothing
// the scan computes, and x1 W1 only on layer 0's h at the same step, which
// a finished layer-0 scan has written.  So:
//   1. the prologue's first part (a warp a row): xp = x0 with rows padded
//      to 8 values (16-byte rows for the GEMM);
//   2. layer 0's input pre-activations P = (xp W0 -> T) + b0 over all S R
//      rows, one GEMM (launch_in, EPI_IN);
//   3. layer 0's forward scan (launch_fwd_scan with FwdEnds): z = P[t] +
//      (h[t-1] U0 -> T), h[-1] = h00 rounded to T, c seeded from c00; hs0
//      always (pass 4 reads it), cs0 (the previous c) only with tapes, and
//      the unrounded h0T and c0T at the last step;
//   4. the prologue's second part: x1 = (hs0 * mask -> T) + s1m -> T, rows
//      padded to 8;
//   5. layer 1's P = (x1 W1 -> T) + b1 into the same P buffer (dead after
//      pass 3);
//   6. layer 1's forward scan, as 3. with h10, c10: hs1, cs1 with tapes,
//      h1T, c1T.
// bfloat16 scans keep U's gate columns resident in a thread-block cluster
// (4 blocks at H = 256, one at H = 128), h exchanged through distributed
// shared memory, one cluster barrier a step; float32 scans stream U from
// L2.  The GEMMs run on the tensor cores in bfloat16 (mma.sync), on the
// CUDA cores in float32.
//
// Backward, in seven passes.  Of the eight products a step of the TPU
// kernel makes, only dh1 <- dz1 U1^T and dh0 <- dz0 U0^T carry from step to
// step; the rest depend on tapes the forward wrote, so they run over all
// S R rows at once:
//   1. the prologue (a warp a row): xp = x0 with rows padded to 8 values,
//      x1 = (hs0 * mask -> T) + s1m -> T, rows padded to 8;
//   2. both layers' pre-activations z = ((in W -> T) + b) + (h_{t-1} U ->
//      T), two GEMMs (EPI_PRE); the h_{t-1} tapes hold h0 in their first R
//      rows, so their operand takes no shift;
//   3. layer 1's reversed scan (launch_scan): the cell backward from z1 and
//      the c tape, dh = (dz1 U1^T) + dhs1, dz1 written over z1; dc seeded
//      with the cotangent of c1_T, and dh10 = dz1_0 U1^T and the last dc
//      carry written at its end (ScanEnds);
//   4. dx1 = dz1 W1^T (EPI_STACK_DX1): ds1m = dx1 -> T and the mid term
//      dx1 * mask in float32;
//   5. layer 0's reversed scan, as 3. with the mid term for dhs;
//   6. dx0 = dz0 W0^T -> T (EPI_STACK_DX0);
//   7. the weight gradients, the deterministic reduction biax_wgrad
//      (biax_common.cuh) over the dz tapes, which also replaces the TPU
//      kernel's VMEM sums across its sequential grid.
// bfloat16 scans keep U resident in a thread-block cluster (4 blocks at
// H = 256, one at H = 128); float32 scans stream U^T from L2.  The wrapper
// (ops/lstm2.py::lstm2_bwd) forms the tapes before pass 1: the h_{t-1}
// tapes, and dhs1 with the cotangent of h1_T added to its last step in
// float32, then rounded to T.

#include "biax_passes.cuh"

namespace biax {

struct StackDims { int S, R, F, H; };

// The layer inputs of every (t, row g) m = t R + g, a warp a row: xp[m] =
// x0[m] (PRO_XTOT) and x1[m] = (hs0[m] * mask -> T) + s1m[m] -> T (PRO_X1;
// the cast order of `_make_fwd_kernel`), each row padded to 8 values with
// zeros.  The forward forms xp first (its pass 1) and x1 once layer 0 has
// run (pass 4), the backward both at once (its pass 1).
constexpr int PRO_ROWS = 8;   // rows (warps) a block

template <typename T, int PARTS>
__global__ void __launch_bounds__(32 * PRO_ROWS) stack_prologue_kernel(
    const T* __restrict__ x0, const T* __restrict__ s1m,
    const T* __restrict__ hs0, T* __restrict__ xp, T* __restrict__ x1,
    StackDims d, Drop drop) {
  const int F = d.F, H = d.H, R = d.R, lx = pad8(F), l1 = pad8(H);
  const size_t m = (size_t)blockIdx.x * PRO_ROWS + threadIdx.x / 32;
  if (m >= (size_t)d.S * R) return;
  const int t = (int)(m / R), g = (int)(m % R), lane = threadIdx.x % 32;
  if constexpr ((PARTS & PRO_XTOT) != 0)
    for (int c = lane; c < lx; c += 32)
      st(xp + m * lx + c, c < F ? ld(x0 + m * F + c) : 0.f);
  if constexpr ((PARTS & PRO_X1) != 0)
    for (int j = lane; j < l1; j += 32) {
      float v = 0.f;
      if (j < H) {
        float hv = ld(hs0 + m * H + j);
        if (drop.on)
          hv = mul_t<T>(hv, mval(drop, S_STACK_MID, 0, t, g, H, j));
        v = add_t<T>(hv, ld(s1m + m * H + j));
      }
      st(x1 + m * l1 + j, v);
    }
}

template <typename T, int PARTS>
int stack_prologue(const void* x0, const void* s1m, const void* hs0,
                   void* xp, void* x1, StackDims d, Drop drop,
                   cudaStream_t st) {
  const int blocks = (int)(((size_t)d.S * d.R + PRO_ROWS - 1) / PRO_ROWS);
  stack_prologue_kernel<T, PARTS><<<blocks, 32 * PRO_ROWS, 0, st>>>(
      (const T*)x0, (const T*)s1m, (const T*)hs0, (T*)xp, (T*)x1, d, drop);
  return (int)cudaGetLastError();
}

}  // namespace biax

// The forward's passes, launched in order by ops/lstm2.py::lstm2_fwd, with
// (S, A, B) = (S, 1, R) and M = S R.
// 1., 4. The prologue's parts (PRO_XTOT or PRO_X1): xp [M][pad8(F)] = x0
// [M][F] padded with zeros, from x0; x1 [M][pad8(H)] = (hs0 * mask -> T) +
// s1m -> T padded with zeros, from s1m and hs0 (the others may be null).
extern "C" int lstm2_fwd_prologue(int bf16, int part, const void* x0,
                                  const void* s1m, const void* hs0, void* xp,
                                  void* x1, int S, int R, int F, int H,
                                  unsigned seed, unsigned thr, float scale,
                                  int dropout, void* stream) {
  using namespace biax;
  const StackDims d = {S, R, F, H};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  if (part != PRO_XTOT && part != PRO_X1) return (int)cudaErrorInvalidValue;
  if (bf16)
    return part == PRO_XTOT
               ? stack_prologue<biax::bf16, PRO_XTOT>(x0, s1m, hs0, xp, x1, d,
                                                      drop, st)
               : stack_prologue<biax::bf16, PRO_X1>(x0, s1m, hs0, xp, x1, d,
                                                    drop, st);
  return part == PRO_XTOT
             ? stack_prologue<float, PRO_XTOT>(x0, s1m, hs0, xp, x1, d, drop,
                                               st)
             : stack_prologue<float, PRO_X1>(x0, s1m, hs0, xp, x1, d, drop,
                                             st);
}

// 2., 5. One layer's input pre-activations P [M][4H] = (xin W -> T) + bias
// over all M rows (launch_in, EPI_IN): xin [M][ldx] with K columns, w in
// the layout of T.
extern "C" int lstm2_fwd_in(int bf16, const void* xin, int ldx, int K,
                            const void* w, const void* bias, void* pre, int M,
                            int H, void* stream) {
  return biax::launch_in(bf16, xin, ldx, K, w, bias, pre, M, H,
                         (cudaStream_t)stream);
}

// 3., 6. One layer's forward scan over P (launch_fwd_scan) with its ends
// (FwdEnds): h0 rounded to T is h[-1], c seeded from c0, the unrounded h
// and the c carry after the last step written to hT, cT (all [R][H]
// float32).  hs [M][H] is always written, cs (the previous c) when not
// null.  cluster = 1 (bfloat16 only): U resident in a thread-block cluster;
// cluster = 0: streamed; u is `_layout(U)` in both.  prof as for the
// stacks' forward scans (may be null).
extern "C" int lstm2_fwd_scan(int bf16, int cluster, const void* pre,
                              void* hs, void* cs, const void* u,
                              const float* h0, const float* c0, float* hT,
                              float* cT, int S, int R, int H, int hard,
                              unsigned long long* prof, void* stream) {
  using namespace biax;
  const PassDims d = {S, 1, R, H, 1};
  const FwdEnds ends = {h0, c0, hT, cT};
  return launch_fwd_scan(bf16, cluster, pre, hs, cs, u, d, hard, prof,
                         (cudaStream_t)stream, ends);
}

// The backward's passes, launched in order by ops/lstm2.py::lstm2_bwd.
// 1. The prologue over M = S R rows, both parts.
extern "C" int lstm2_bwd_prologue(int bf16, const void* x0, const void* s1m,
                                  const void* hs0, void* xp, void* x1, int S,
                                  int R, int F, int H, unsigned seed,
                                  unsigned thr, float scale, int dropout,
                                  void* stream) {
  using namespace biax;
  const StackDims d = {S, R, F, H};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return stack_prologue<biax::bf16, PRO_XTOT | PRO_X1>(x0, s1m, hs0, xp, x1,
                                                         d, drop, st);
  return stack_prologue<float, PRO_XTOT | PRO_X1>(x0, s1m, hs0, xp, x1, d,
                                                  drop, st);
}

// 2. One layer's pre-activations z [M][4H] = ((xin W -> T) + bias) + (hp U
// -> T) over all M rows (EPI_PRE): xin [M][ldx] with K columns, hp [M][H]
// the h_{t-1} tape (no shift: its first R rows hold the initial h), w and u
// in the layout of T.
extern "C" int lstm2_bwd_preact(int bf16, const void* xin, int ldx, int K,
                                const void* w, const void* bias,
                                const void* hp, const void* u, void* z, int M,
                                int H, void* stream) {
  using namespace biax;
  const int H4 = 4 * H;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    const EpiArgs<biax::bf16> e = {(biax::bf16*)z, (const biax::bf16*)bias};
    return gemm<biax::bf16, EPI_PRE>(
        operand<biax::bf16>(xin, ldx, 0, K, w, H4),
        operand<biax::bf16>(hp, H, 0, H, u, H4), M, H4, e, st);
  }
  const EpiArgs<float> e = {(float*)z, (const float*)bias};
  return gemm<float, EPI_PRE>(operand<float>(xin, ldx, 0, K, w, H4),
                              operand<float>(hp, H, 0, H, u, H4), M, H4, e,
                              st);
}

// 3., 5. One layer's reversed scan over z_dz (z in, dz out) with the
// external dh ext_t (T) or ext_f (float32) [S][R][H], the c_{t-1} tape cs,
// dc seeded from dcT, and the initial-state gradients dh0, dc0 [R][H]
// written at its end (launch_scan with ScanEnds).  cluster = 1 (bfloat16
// only): u is U [H][4H], resident in a thread-block cluster; cluster = 0: u
// is `_layout(U^T)`, streamed.  prof as for the stacks' scans (may be
// null).
extern "C" int lstm2_bwd_scan(int bf16, int cluster, void* z_dz,
                              const void* cs, const void* ext_t,
                              const float* ext_f, const void* u,
                              const float* dcT, float* dh0, float* dc0,
                              int S, int R, int H, int hard,
                              unsigned long long* prof, void* stream) {
  using namespace biax;
  const PassDims d = {S, 1, R, H, 1};
  const ScanEnds ends = {dcT, dh0, dc0};
  return launch_scan(bf16, cluster, z_dz, cs, ext_t, ext_f, u, d, hard, prof,
                     (cudaStream_t)stream, ends);
}

// 4., 6. The product dz [M][4H] W^T (wt = `_layout(W^T)`, an Nout-wide
// result).  layer 1 (EPI_STACK_DX1): out_t = ds1m (T), out_b = the mid term
// (float32); layer 0 (EPI_STACK_DX0): out_t = dx0 (T).
extern "C" int lstm2_bwd_dx(int bf16, int layer, const void* dz,
                            const void* wt, int S, int R, int H, int Nout,
                            void* out_t, float* out_b, unsigned seed,
                            unsigned thr, float scale, int dropout,
                            void* stream) {
  using namespace biax;
  const PassDims d = {S, 1, R, H, 1};
  const Drop drop = {seed, thr, scale, dropout};
  const int M = S * R, H4 = 4 * H;
  cudaStream_t st = (cudaStream_t)stream;
  return layer ? launch_dx<EPI_STACK_DX1>(bf16, dz, wt, M, H4, Nout, out_t,
                                          nullptr, out_b, nullptr, 0, d, drop,
                                          st)
               : launch_dx<EPI_STACK_DX0>(bf16, dz, wt, M, H4, Nout, out_t,
                                          nullptr, nullptr, nullptr, 0, d,
                                          drop, st);
}
