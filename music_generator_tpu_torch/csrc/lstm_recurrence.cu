// The single-layer LSTM recurrence over a precomputed input projection as
// CUDA kernels for Hopper (sm_90a): forward and backward of one layer
// scanning S steps over R rows, z = xw_t + (h_{t-1} U -> T).
//
// Replaces music_generator_tpu/ops/pallas_lstm.py: `_forward_impl` (kernel
// `_fwd_kernel`) and `_bwd_rule` (kernel `_bwd_kernel`, custom VJP
// `_make_recurrence`).  xw = x W + b comes in already projected, in the
// compute dtype T (ops/lstm.py::lstm_scan).  The forward writes hs and the
// previous-c tape cs in T (cs only when the caller will differentiate) and
// the terminal h_T (not rounded) and c_T in float32.  The backward recomputes
// the gates from xw and the h_{t-1} / c_{t-1} tapes, carries dh and dc
// (dc seeded with the cotangent of c_T; the cotangent of h_T arrives folded
// into dhs[S-1]) and writes dxw = dz in T and the initial-state gradients;
// biax_wgrad (biax_common.cuh) then reduces dU = sum_t h_{t-1}^T dz_t.
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
// Design (simple first, the layout of biax_time.cu).  One block owns RB rows
// for the whole scan and keeps h, c, the pre-activations and the gates in
// shared memory; U streams from L2 every step.  bf16 products run on the
// tensor cores (mma.sync, float32 accumulation, `matvec_mma`), float32 on
// the CUDA cores (`matvec_fma`).  Blocks never talk to each other, so dU,
// which the TPU kernel summed in VMEM across its sequential grid, is the
// second, deterministic reduction over the dz tape.  The note-axis U fits
// one block's shared memory and the time-axis U does not: keeping U resident
// (in a block, or across a cluster) is later work.

#include "biax_common.cuh"

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

template <typename T, int RB>
__global__ void __launch_bounds__(1024) rec_bwd_kernel(
    const T* __restrict__ xw, const T* __restrict__ u,
    const T* __restrict__ ut, const T* __restrict__ hs_prev,
    const T* __restrict__ cs, const float* __restrict__ dhs,
    const float* __restrict__ dcT, T* dxw, float* dh0, float* dc0,
    RecDims d, int hard) {
  extern __shared__ float sm[];
  const int H = d.H, H4 = 4 * H, R = d.R, lH = padk(H), l4 = padk(H4);
  float* hp = sm;             // [RB][lH] h_{t-1} in T, zero padded
  float* dz = hp + RB * lH;   // [RB][l4] dz in T, zero padded
  float* z = dz + RB * l4;    // [RB][H4] the pre-activations
  float* cp = z + RB * H4;    // [RB][H] c_{t-1}
  float* dh = cp + RB * H;    // [RB][H] the dh carry
  float* dc = dh + RB * H;    // [RB][H] the dc carry
  float* scr = dc + RB * H;
  const int tid = threadIdx.x, nt = blockDim.x, g0 = blockIdx.x * RB;
  for (int i = tid; i < RB * (lH + l4); i += nt) sm[i] = 0.f;
  for (int i = tid; i < RB * H; i += nt) {
    const int g = g0 + i / H;
    dh[i] = 0.f;
    dc[i] = g < R ? dcT[(size_t)g * H + i % H] : 0.f;
  }
  __syncthreads();
  for (int t = d.S - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * R + g0;
    for (int i = tid; i < RB * H4; i += nt)
      z[i] = g0 + i / H4 < R ? ld(xw + row0 * H4 + i) : 0.f;
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H;
      const bool in = g0 + rr < R;
      hp[rr * lH + j] = in ? ld(hs_prev + row0 * H + i) : 0.f;
      cp[i] = in ? ld(cs + row0 * H + i) : 0.f;
    }
    __syncthreads();
    matvec<T, RB>(hp, lH, H, u, H4, scr, [&](int rr, int col, float s) {
      z[rr * H4 + col] = add_t<T>(z[rr * H4 + col], rnd<T>(s));
    });
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H;
      const Gates q = gates<T>(z + rr * H4, H, j, hard);
      const float tc = tanh_c<T>(q, cp[i]);
      float dhv = dh[i];
      if (g0 + rr < R) dhv += dhs[row0 * H + i];
      dc[i] = cell_bwd<T>(q, cp[i], tc, dhv, dc[i], hard, dz + rr * l4, H,
                          j);
    }
    __syncthreads();
    for (int i = tid; i < RB * H4; i += nt)
      if (g0 + i / H4 < R)
        st(dxw + row0 * H4 + i, dz[(i / H4) * l4 + i % H4]);
    matvec<T, RB>(dz, l4, H4, ut, H, scr,
                  [&](int rr, int col, float s) { dh[rr * H + col] = s; });
  }
  for (int i = tid; i < RB * H; i += nt) {
    const int g = g0 + i / H;
    if (g < R) {
      dh0[(size_t)g * H + i % H] = dh[i];
      dc0[(size_t)g * H + i % H] = dc[i];
    }
  }
}

constexpr int FWD_RB = 8;   // 96 blocks on the time axis, 256 on the note axis
constexpr int BWD_RB = 6;   // 128 blocks on the time axis: one wave

inline int threads_for(int H4) {
  const int nt = ((H4 + 31) / 32) * 32;
  return nt > 1024 ? 1024 : nt;
}

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

template <typename T>
int rec_bwd(const void* xw, const void* u, const void* ut,
            const void* hs_prev, const void* cs, const float* dhs,
            const float* dcT, void* dxw, float* dh0, float* dc0, RecDims d,
            int hard, cudaStream_t st) {
  const int H4 = 4 * d.H, nt = threads_for(H4), RB = BWD_RB;
  const size_t smem = sizeof(float) *
      (RB * (padk(d.H) + padk(H4) + H4 + 3 * d.H) + (size_t)nt * RB);
  auto kern = rec_bwd_kernel<T, BWD_RB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<(d.R + RB - 1) / RB, nt, smem, st>>>(
      (const T*)xw, (const T*)u, (const T*)ut, (const T*)hs_prev,
      (const T*)cs, dhs, dcT, (T*)dxw, dh0, dc0, d, hard);
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

// ut is U^T in the same layouts: [4H][H] for float32, [H][padk(4H)] for bf16.
extern "C" int lstm_rec_bwd(int bf16, const void* xw, const void* u,
                            const void* ut, const void* hs_prev,
                            const void* cs, const float* dhs,
                            const float* dcT, void* dxw, float* dh0,
                            float* dc0, int S, int R, int H, int hard,
                            void* stream) {
  using namespace biax;
  const RecDims d = {S, R, H};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return rec_bwd<biax::bf16>(xw, u, ut, hs_prev, cs, dhs, dcT, dxw, dh0,
                               dc0, d, hard, st);
  return rec_bwd<float>(xw, u, ut, hs_prev, cs, dhs, dcT, dxw, dh0, dc0, d,
                        hard, st);
}
