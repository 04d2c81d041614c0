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
// Forward (simple first, the layout of biax_time.cu).  One block owns RB
// rows for the whole scan and keeps h, c, the pre-activations and the gates
// in shared memory; U streams from L2 every step.  bf16 products run on the
// tensor cores (mma.sync, float32 accumulation, `matvec_mma`), float32 on
// the CUDA cores (`matvec_fma`).
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

namespace biax {

struct RecDims { int S, R, H; };

template <typename T, int RB>
__global__ void __launch_bounds__(1024) rec_fwd_kernel(
    const T* __restrict__ xw, const T* __restrict__ u,
    const float* __restrict__ h0, const float* __restrict__ c0, T* hs, T* cs,
    float* hT, float* cT, RecDims d, int hard) {
  extern __shared__ float sm[];
  const int H = d.H, H4 = 4 * H, R = d.R, lH = padk(H);
  float* h = sm;              // [RB][lH] the previous h in T, zero padded
  float* c = h + RB * lH;     // [RB][H]
  float* z = c + RB * H;      // [RB][H4]
  float* scr = z + RB * H4;
  const int tid = threadIdx.x, nt = blockDim.x, g0 = blockIdx.x * RB;
  for (int i = tid; i < RB * lH; i += nt) {
    const int j = i % lH, g = g0 + i / lH;
    h[i] = (j < H && g < R) ? rnd<T>(h0[(size_t)g * H + j]) : 0.f;
  }
  for (int i = tid; i < RB * H; i += nt) {
    const int g = g0 + i / H;
    c[i] = g < R ? c0[(size_t)g * H + i % H] : 0.f;
  }
  for (int t = 0; t < d.S; ++t) {
    const T* xt = xw + ((size_t)t * R + g0) * H4;
    for (int i = tid; i < RB * H4; i += nt)
      z[i] = g0 + i / H4 < R ? ld(xt + i) : 0.f;
    __syncthreads();
    matvec<T, RB>(h, lH, H, u, H4, scr, [&](int rr, int col, float s) {
      z[rr * H4 + col] = add_t<T>(z[rr * H4 + col], rnd<T>(s));
    });
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      const Gates q = gates<T>(z + rr * H4, H, j, hard);
      const float cp = c[i];
      float hn;
      const float cn = cell<T>(q, cp, &hn);
      c[i] = cn;
      h[rr * lH + j] = hn;
      if (g < R) {
        const size_t o = ((size_t)t * R + g) * H + j;
        st(hs + o, hn);
        if (cs) st(cs + o, cp);
        if (t == d.S - 1) {
          hT[(size_t)g * H + j] = __fmul_rn(q.o, tanh_t<T>(rnd<T>(cn)));
          cT[(size_t)g * H + j] = cn;
        }
      }
    }
    __syncthreads();
  }
}

constexpr int FWD_RB = 8;   // 96 blocks on the time axis, 256 on the note axis

template <typename T>
int rec_fwd(const void* xw, const void* u, const float* h0, const float* c0,
            void* hs, void* cs, float* hT, float* cT, RecDims d, int hard,
            cudaStream_t st) {
  const int H4 = 4 * d.H, nt = threads_for(H4), RB = FWD_RB;
  const size_t smem =
      sizeof(float) * (RB * (padk(d.H) + d.H + H4) + (size_t)nt * RB);
  auto kern = rec_fwd_kernel<T, FWD_RB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<(d.R + RB - 1) / RB, nt, smem, st>>>(
      (const T*)xw, (const T*)u, h0, c0, (T*)hs, (T*)cs, hT, cT, d, hard);
  return (int)cudaGetLastError();
}

}  // namespace biax

// u is the recurrent matrix in the layout of the compute dtype (see
// matvec in biax_common.cuh): [H][4H] for float32, [4H][padk(H)] for bf16.
extern "C" int lstm_rec_fwd(int bf16, const void* xw, const void* u,
                            const float* h0, const float* c0, void* hs,
                            void* cs, float* hT, float* cT, int S, int R,
                            int H, int hard, void* stream) {
  using namespace biax;
  const RecDims d = {S, R, H};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return rec_fwd<biax::bf16>(xw, u, h0, c0, hs, cs, hT, cT, d, hard, st);
  return rec_fwd<float>(xw, u, h0, c0, hs, cs, hT, cT, d, hard, st);
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
