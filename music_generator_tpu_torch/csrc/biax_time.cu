// The time-axis training stack of DeepJ as CUDA kernels for Hopper (sm_90a):
// forward and backward of two stacked LSTM layers scanning T = 128 steps,
// with rows (n, b) over the 48 notes and the batch.
//
// Replaces music_generator_tpu/ops/pallas_biax.py: `_time_fwd_impl`
// (kernel `_time_fwd_kernel`) and `_time_bwd_impl` (kernel
// `_time_bwd_kernel`, custom VJP `_make_time_stack`).  Per step t and row:
// x + style-0 term (masked, S_STYLE0) -> layer 0 (z = (x W0 -> T) + b0 +
// (h U0 -> T)) -> inter-layer dropout (S_MID) + style-1 term (S_STYLE1) ->
// layer 1 -> hs1.  Tapes hs0, cs0 (the previous c), hs1, cs1 in the compute
// dtype, as the Pallas kernel writes them.  The backward recomputes the
// gates from the tapes (the previous h is zero at t = 0), regenerates the
// masks, and writes dx, the per-row style-gradient terms and the dz tapes;
// biax_wgrad (biax_common.cuh) then reduces dW, dU and db, and
// `biax_time_ds` sums the style gradients over the notes in the TPU's tile
// groups (each tile's sum rounded to T, as the Pallas kernel's per-tile
// partials are).
//
// What bounds it on this card.  At the flagship shapes (T = 128, N = 48,
// B = 16, F = 94, H = 256) the forward does 2 T N B (F + 3H) 4H + 20 T N B
// 4H = 176 GFLOP and the backward about 3x that (525 GFLOP) (the Pallas
// CostEstimates); at the H100's 989 TFLOP/s bf16 that is 0.18 and 0.53 ms.
// The bytes (about 220 MB for the forward) take 0.07 ms at 3.35 TB/s.  The
// real floor is the chain of 128 dependent steps.
//
// Both directions run in passes, because only one product carries from
// step to step: h U in the forward, dh <- dz U^T in the backward.
//
// Forward, in six passes.  x W0 depends only on the inputs, and x1 W1 only
// on layer 0's h at the same step, so (1) an elementwise pass forms xtot
// (the first half of the prologue below); (2) a tiled GEMM forms layer 0's
// input pre-activations P = (xtot W0 -> T) + b0 for all T N B rows at once
// (EPI_IN); (3) the layer-0 scan runs the cell forward with one h U0
// product a step and writes hs0 (always: layer 1 reads it) and cs0 (when
// tapes are wanted); (4) the prologue's second half forms x1 from hs0;
// (5) a GEMM forms layer 1's P into the same buffer; (6) the layer-1 scan
// writes hs1 and cs1.
//
// Backward, in six passes.  The forward's gates at step t depend only on
// tapes the forward wrote, and dx1 = dz1 W1^T, dx = dz0 W0^T feed nothing
// later in the chain.  So the products that do not carry leave the scans:
// (1) the prologue forms both layer inputs xtot and x1; (2) a tiled GEMM
// forms both layers' pre-activations z for all T N B rows at once; (3) the
// layer-1 scan, reversed, runs the cell backward and one product dz1 U1^T
// per step; (4) a GEMM forms dx1 = dz1 W1^T with the style-1 rows and the
// mid term in its epilogue; (5) the layer-0 scan; (6) a GEMM forms
// dx = dz0 W0^T and the style-0 rows.  The scans overwrite z with dz in
// place.  Blocks never talk across clusters, so the weight gradients,
// which the TPU kernel summed in VMEM across its sequential grid, are a
// second, deterministic reduction over the dz tapes.
//
// The GEMMs run on the tensor cores in bfloat16 (mma.sync, cp.async ring)
// and on the CUDA cores in float32.  The bfloat16 scans keep U resident in
// a thread-block cluster's shared memory (loaded once per launch; h or dz
// exchanged through distributed shared memory; the forward double-buffers
// h and needs one cluster barrier a step, the backward two); the float32
// scans stream U from L2 (RB = 6 rows a block).  The choice is by dtype,
// fixed in the wrapper.  The prologue is this file's; the other passes are
// the shared machinery of biax_passes.cuh with (S, A) = (T, N), which the
// note stack (biax_note.cu) runs with (S, A) = (N, T).

#include "biax_passes.cuh"

namespace biax {

struct TimeDims { int T, N, B, F, H, k; };

// ---------------------------------------------------------------------------
// The passes (see the note at the top; the rest in biax_passes.cuh).
// ---------------------------------------------------------------------------

// The prologue: the layer inputs of every (t, row) m = t R + g:
// xtot[m] = x + style-0 (masked), x1[m] = hs0 (masked) + style-1 (masked),
// rows padded to 8 values with zeros.  `halves` selects them (PRO_XTOT,
// PRO_X1 or both): the forward forms xtot first (its pass 1) and x1 once
// layer 0 has run (pass 4), the backward both at once (its pass 1).  One
// block a row, threads over the selected columns.

template <typename T>
__global__ void __launch_bounds__(128) time_prologue_kernel(
    const T* __restrict__ x, const T* __restrict__ s0,
    const T* __restrict__ s1, const T* __restrict__ hs0,
    T* __restrict__ xtot, T* __restrict__ x1, TimeDims d, Drop drop,
    int halves) {
  const int F = d.F, H = d.H, R = d.N * d.B, lx = pad8(F), l1 = pad8(H);
  const int m = blockIdx.x, t = m / R;
  const RowPos p = row_pos(m % R, d.B, d.k);
  const int c0 = (halves & PRO_XTOT) ? 0 : lx;
  const int c1 = (halves & PRO_X1) ? lx + l1 : lx;
  for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    float v = 0.f;
    if (c < F) {
      float s = ld(s0 + ((size_t)t * d.B + p.b) * F + c);
      if (drop.on) s = mul_t<T>(s, mval(drop, S_STYLE0, p.j, t, p.r, F, c));
      v = add_t<T>(ld(x + (size_t)m * F + c), s);
    } else if (c >= lx && c - lx < H) {
      const int j = c - lx;
      float hv = ld(hs0 + (size_t)m * H + j);
      float s = ld(s1 + ((size_t)t * d.B + p.b) * H + j);
      if (drop.on) {
        hv = mul_t<T>(hv, mval(drop, S_MID, p.j, t, p.r, H, j));
        s = mul_t<T>(s, mval(drop, S_STYLE1, p.j, t, p.r, H, j));
      }
      v = add_t<T>(hv, s);
    }
    if (c < lx)
      st(xtot + (size_t)m * lx + c, v);
    else
      st(x1 + (size_t)m * l1 + c - lx, v);
  }
}

// out[t][b][c] = sum over tiles j of (sum over the k notes of tile j of
// rows[t][n][b][c], rounded to T): the style gradient of the time stack.
template <typename T>
__global__ void time_ds_kernel(const float* __restrict__ rows, int T_, int N,
                               int B, int W, int k, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)T_ * B * W) return;
  const int c = i % W, b = (i / W) % B, t = i / ((size_t)W * B);
  float tot = 0.f;
  for (int j = 0; j < N / k; ++j) {
    float part = 0.f;
    for (int n = j * k; n < (j + 1) * k; ++n)
      part += rows[(((size_t)t * N + n) * B + b) * W + c];
    tot += rnd<T>(part);
  }
  out[i] = tot;
}

}  // namespace biax

// The passes, launched in order by ops/biax.py::biax_time_fwd and
// biax_time_bwd.
// The prologue: xtot [T R][pad8(F)] from x and s0 (halves & 1), x1
// [T R][pad8(H)] from s1 and hs0 (halves & 2).
extern "C" int biax_time_prologue(int bf16, int halves, const void* x,
                                  const void* s0, const void* s1,
                                  const void* hs0, void* xtot, void* x1,
                                  int T, int N, int B, int F, int H, int k,
                                  unsigned seed, unsigned thr, float scale,
                                  int dropout, void* stream) {
  using namespace biax;
  const TimeDims d = {T, N, B, F, H, k};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = T * N * B;
  if (bf16)
    time_prologue_kernel<biax::bf16><<<blocks, 128, 0, st>>>(
        (const biax::bf16*)x, (const biax::bf16*)s0, (const biax::bf16*)s1,
        (const biax::bf16*)hs0, (biax::bf16*)xtot, (biax::bf16*)x1, d, drop,
        halves);
  else
    time_prologue_kernel<float><<<blocks, 128, 0, st>>>(
        (const float*)x, (const float*)s0, (const float*)s1,
        (const float*)hs0, (float*)xtot, (float*)x1, d, drop, halves);
  return (int)cudaGetLastError();
}

// Forward 2., 5. One layer's input pre-activations P [M][4H] (launch_in).
extern "C" int biax_time_fwd_in(int bf16, const void* xin, int ldx, int K,
                                const void* w, const void* bias, void* pre,
                                int M, int H, void* stream) {
  return biax::launch_in(bf16, xin, ldx, K, w, bias, pre, M, H,
                         (cudaStream_t)stream);
}

// Forward 3., 6. One layer's forward scan over P (launch_fwd_scan).
extern "C" int biax_time_fwd_scan(int bf16, int cluster, const void* pre,
                                  void* hs, void* cs, const void* u, int T,
                                  int N, int B, int H, int k, int hard,
                                  unsigned long long* prof, void* stream) {
  const biax::PassDims d = {T, N, B, H, k};
  return biax::launch_fwd_scan(bf16, cluster, pre, hs, cs, u, d, hard, prof,
                               (cudaStream_t)stream);
}

// Backward 2. One layer's pre-activations over all M = T R rows
// (launch_preact).
extern "C" int biax_time_bwd_preact(int bf16, const void* xin, int ldx,
                                    int K, const void* w, const void* bias,
                                    const void* hs, const void* u, void* z,
                                    int M, int R, int H, void* stream) {
  return biax::launch_preact(bf16, xin, ldx, K, w, bias, hs, u, z, M, R, H,
                             (cudaStream_t)stream);
}

// Backward 3., 5. One layer's reversed scan over z_dz (launch_scan).
extern "C" int biax_time_bwd_scan(int bf16, int cluster, void* z_dz,
                                  const void* cs, const void* ext_t,
                                  const void* ext_f, const void* u, int T,
                                  int N, int B, int F, int H, int k,
                                  int hard, unsigned long long* prof,
                                  void* stream) {
  const biax::PassDims d = {T, N, B, H, k};
  return biax::launch_scan(bf16, cluster, z_dz, cs, ext_t, ext_f, u, d, hard,
                           prof, (cudaStream_t)stream);
}

// Backward 4., 6. The product dz [M][4H] W^T (wt = `_layout(W^T)`, an Nout-wide
// result).  layer 1: out_a = style-1 rows, out_b = the mid term (float32).
// layer 0: out_t = dx (T), out_a = style-0 rows.
extern "C" int biax_time_bwd_dx(int bf16, int layer, const void* dz,
                                const void* wt, int M, int K, int Nout,
                                void* out_t, float* out_a, float* out_b,
                                int T, int N, int B, int F, int H, int k,
                                unsigned seed, unsigned thr, float scale,
                                int dropout, void* stream) {
  using namespace biax;
  const PassDims d = {T, N, B, H, k};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  return layer ? launch_dx<EPI_DX1>(bf16, dz, wt, M, K, Nout, out_t, out_a,
                                    out_b, nullptr, 0, d, drop, st)
               : launch_dx<EPI_DX0>(bf16, dz, wt, M, K, Nout, out_t, out_a,
                                    out_b, nullptr, 0, d, drop, st);
}

extern "C" int biax_time_ds(int bf16, const float* rows, int T, int N, int B,
                            int W, int k, float* out, void* stream) {
  using namespace biax;
  const size_t n = (size_t)T * B * W;
  const int blocks = (int)((n + 255) / 256);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    time_ds_kernel<biax::bf16><<<blocks, 256, 0, st>>>(rows, T, N, B, W, k,
                                                       out);
  else
    time_ds_kernel<float><<<blocks, 256, 0, st>>>(rows, T, N, B, W, k, out);
  return (int)cudaGetLastError();
}
