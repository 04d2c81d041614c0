// One DeepJ axis as a fused two-layer LSTM stack, as CUDA kernels for Hopper
// (sm_90a): forward and backward of two stacked layers scanning S steps over
// R rows, both input projections inside the kernel.
//
// Replaces music_generator_tpu/ops/pallas_lstm2.py: `_forward_impl` (kernel
// `_make_fwd_kernel`) and `_bwd_impl` (kernel `_make_bwd_kernel`, custom VJP
// `_make_stack`).  Per step t and row: layer 0 (z = (x0 W0 -> T) + b0 +
// (h U0 -> T)) -> x1 = h0 * mask + s1m in T -> layer 1 (z = (x1 W1 -> T) +
// b1 + (h U1 -> T)) -> hs1.  Tapes hs0, cs0 (the previous c), cs1 in T, only
// when the caller will differentiate; the terminal states in float32 (h not
// rounded).  The backward recomputes both cells from the tapes, regenerates
// the mask, and writes dx0, ds1m, the layer-1 input tape x1 and the dz tapes;
// biax_wgrad (biax_common.cuh) then reduces dW0, db0, dU0, dW1, dU1, db1.
// The cotangent of h0T is not an input: the TPU kernel ignores it too.
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
// dependent steps, each a product with all 1.8 MB (time) or 0.6 MB (note)
// of the stack's bf16 weights.
//
// Design (simple first): biax_time.cu's.  One block owns RB rows for the
// whole scan and keeps h, c, the gates and the layer inputs in shared
// memory; the weights stream from L2 every step.  bf16 products run on the
// tensor cores (mma.sync, float32 accumulation), float32 on the CUDA cores.
// The weight gradients, which the TPU kernel summed in VMEM across its
// sequential grid, are the second, deterministic reduction over the tapes.

#include "biax_common.cuh"

namespace biax {

struct StackDims { int S, R, F, H; };

template <typename T, int RB>
__global__ void __launch_bounds__(1024) stack_fwd_kernel(
    const T* __restrict__ x0, const T* __restrict__ s1m,
    const T* __restrict__ w0, const T* __restrict__ b0,
    const T* __restrict__ b1, const T* __restrict__ u0,
    const T* __restrict__ w1, const T* __restrict__ u1,
    const float* __restrict__ h00, const float* __restrict__ c00,
    const float* __restrict__ h10, const float* __restrict__ c10, T* hs0,
    T* cs0, T* hs1, T* cs1, float* h0T, float* c0T, float* h1T, float* c1T,
    StackDims d, Drop drop, int hard) {
  extern __shared__ float sm[];
  const int F = d.F, H = d.H, H4 = 4 * H, R = d.R;
  const int lF = padk(F), lH = padk(H);
  // Product inputs (rows padded to 32 with zeros): xin, x1, h0, h1.
  float* xin = sm;
  float* x1 = xin + RB * lF;
  float* h0 = x1 + RB * lH;
  float* h1 = h0 + RB * lH;
  float* c0 = h1 + RB * lH;
  float* c1 = c0 + RB * H;
  float* z = c1 + RB * H;
  float* scr = z + RB * H4;
  const int tid = threadIdx.x, nt = blockDim.x, g0 = blockIdx.x * RB;
  for (int i = tid; i < RB * (lF + lH); i += nt) sm[i] = 0.f;
  for (int i = tid; i < RB * lH; i += nt) {
    const int j = i % lH, g = g0 + i / lH;
    const bool in = j < H && g < R;
    h0[i] = in ? rnd<T>(h00[(size_t)g * H + j]) : 0.f;
    h1[i] = in ? rnd<T>(h10[(size_t)g * H + j]) : 0.f;
  }
  for (int i = tid; i < RB * H; i += nt) {
    const int g = g0 + i / H;
    c0[i] = g < R ? c00[(size_t)g * H + i % H] : 0.f;
    c1[i] = g < R ? c10[(size_t)g * H + i % H] : 0.f;
  }
  __syncthreads();
  for (int t = 0; t < d.S; ++t) {
    const size_t row0 = (size_t)t * R + g0;
    for (int i = tid; i < RB * F; i += nt) {
      const int rr = i / F, f = i % F;
      xin[rr * lF + f] = g0 + rr < R ? ld(x0 + row0 * F + i) : 0.f;
    }
    __syncthreads();
    preact<T, RB>(xin, lF, F, w0, b0, h0, lH, H, u0, z, scr);
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      const Gates q = gates<T>(z + rr * H4, H, j, hard);
      const float cp = c0[i];
      float hn;
      const float cn = cell<T>(q, cp, &hn);
      c0[i] = cn;
      h0[rr * lH + j] = hn;
      float xv = 0.f;
      if (g < R) {
        const size_t o = row0 * H + i;
        if (cs0) st(cs0 + o, cp);
        if (hs0) st(hs0 + o, hn);
        if (t == d.S - 1) {
          h0T[(size_t)g * H + j] = __fmul_rn(q.o, tanh_t<T>(rnd<T>(cn)));
          c0T[(size_t)g * H + j] = cn;
        }
        const float hv =
            drop.on ? mul_t<T>(hn, mval(drop, S_STACK_MID, 0, t, g, H, j))
                    : hn;
        xv = add_t<T>(hv, ld(s1m + o));
      }
      x1[rr * lH + j] = xv;
    }
    __syncthreads();
    preact<T, RB>(x1, lH, H, w1, b1, h1, lH, H, u1, z, scr);
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      const Gates q = gates<T>(z + rr * H4, H, j, hard);
      const float cp = c1[i];
      float hn;
      const float cn = cell<T>(q, cp, &hn);
      c1[i] = cn;
      h1[rr * lH + j] = hn;
      if (g < R) {
        const size_t o = row0 * H + i;
        if (cs1) st(cs1 + o, cp);
        st(hs1 + o, hn);
        if (t == d.S - 1) {
          h1T[(size_t)g * H + j] = __fmul_rn(q.o, tanh_t<T>(rnd<T>(cn)));
          c1T[(size_t)g * H + j] = cn;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int RB>
__global__ void __launch_bounds__(1024) stack_bwd_kernel(
    const T* __restrict__ x0, const T* __restrict__ s1m,
    const T* __restrict__ w0, const T* __restrict__ b0,
    const T* __restrict__ b1, const T* __restrict__ u0,
    const T* __restrict__ w1, const T* __restrict__ u1,
    const T* __restrict__ w0t, const T* __restrict__ u0t,
    const T* __restrict__ w1t, const T* __restrict__ u1t,
    const T* __restrict__ hs0p, const T* __restrict__ cs0,
    const T* __restrict__ hs1p, const T* __restrict__ cs1,
    const T* __restrict__ hs0, const T* __restrict__ dhs1,
    const float* __restrict__ dc0T, const float* __restrict__ dc1T, T* dx0,
    T* ds1m, T* x1tape, T* dz0t, T* dz1t, float* dh00, float* dc00,
    float* dh10, float* dc10, StackDims d, Drop drop, int hard) {
  extern __shared__ float sm[];
  const int F = d.F, H = d.H, H4 = 4 * H, R = d.R;
  const int lF = padk(F), lH = padk(H), l4 = padk(H4);
  // Product inputs (rows padded to 32 with zeros): xin, x1, hp0, hp1, dz.
  float* xin = sm;
  float* x1 = xin + RB * lF;
  float* hp0 = x1 + RB * lH;
  float* hp1 = hp0 + RB * lH;
  float* dz = hp1 + RB * lH;
  float* cp0 = dz + RB * l4;
  float* cp1 = cp0 + RB * H;
  float* tc0 = cp1 + RB * H;
  float* tc1 = tc0 + RB * H;
  float* dh0 = tc1 + RB * H;
  float* dc0 = dh0 + RB * H;
  float* dh1 = dc0 + RB * H;
  float* dc1 = dh1 + RB * H;
  float* dx1 = dc1 + RB * H;
  float* z0 = dx1 + RB * H;
  float* z1 = z0 + RB * H4;
  float* dxo = z1 + RB * H4;
  float* scr = dxo + RB * F;
  const int tid = threadIdx.x, nt = blockDim.x, g0 = blockIdx.x * RB;
  for (int i = tid; i < RB * (lF + 3 * lH + l4 + 9 * H + 2 * H4); i += nt)
    sm[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < RB * H; i += nt) {
    const int g = g0 + i / H;
    dc0[i] = g < R ? dc0T[(size_t)g * H + i % H] : 0.f;
    dc1[i] = g < R ? dc1T[(size_t)g * H + i % H] : 0.f;
  }
  for (int t = d.S - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * R + g0;
    // Recompute the forward of step t from the tapes.
    for (int i = tid; i < RB * F; i += nt) {
      const int rr = i / F, f = i % F;
      xin[rr * lF + f] = g0 + rr < R ? ld(x0 + row0 * F + i) : 0.f;
    }
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H;
      const bool in = g0 + rr < R;
      hp0[rr * lH + j] = in ? ld(hs0p + row0 * H + i) : 0.f;
      hp1[rr * lH + j] = in ? ld(hs1p + row0 * H + i) : 0.f;
      cp0[i] = in ? ld(cs0 + row0 * H + i) : 0.f;
      cp1[i] = in ? ld(cs1 + row0 * H + i) : 0.f;
    }
    __syncthreads();
    preact<T, RB>(xin, lF, F, w0, b0, hp0, lH, H, u0, z0, scr);
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      float* zr = z0 + rr * H4;
      const Gates q = gates<T>(zr, H, j, hard);
      zr[j] = q.i;
      zr[H + j] = q.f;
      zr[2 * H + j] = q.g;
      zr[3 * H + j] = q.o;
      tc0[i] = tanh_c<T>(q, cp0[i]);
      float xv = 0.f;
      if (g < R) {
        const size_t o = row0 * H + i;
        float hv = ld(hs0 + o);
        if (drop.on) hv = mul_t<T>(hv, mval(drop, S_STACK_MID, 0, t, g, H, j));
        xv = add_t<T>(hv, ld(s1m + o));
        st(x1tape + o, xv);
      }
      x1[rr * lH + j] = xv;
    }
    __syncthreads();
    preact<T, RB>(x1, lH, H, w1, b1, hp1, lH, H, u1, z1, scr);
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H;
      float* zr = z1 + rr * H4;
      const Gates q = gates<T>(zr, H, j, hard);
      zr[j] = q.i;
      zr[H + j] = q.f;
      zr[2 * H + j] = q.g;
      zr[3 * H + j] = q.o;
      tc1[i] = tanh_c<T>(q, cp1[i]);
    }
    __syncthreads();

    // Layer 1 backward.
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H;
      const float* zr = z1 + rr * H4;
      const Gates q = {zr[j], zr[H + j], zr[2 * H + j], zr[3 * H + j]};
      float dh = dh1[i];
      if (g0 + rr < R) dh += ld(dhs1 + row0 * H + i);
      dc1[i] = cell_bwd<T>(q, cp1[i], tc1[i], dh, dc1[i], hard,
                           dz + rr * l4, H, j);
    }
    __syncthreads();
    for (int i = tid; i < RB * H4; i += nt)
      if (g0 + i / H4 < R)
        st(dz1t + row0 * H4 + i, dz[(i / H4) * l4 + i % H4]);
    matvec<T, RB>(dz, l4, H4, u1t, H, scr,
                  [&](int rr, int c, float s) { dh1[rr * H + c] = s; });
    matvec<T, RB>(dz, l4, H4, w1t, H, scr,
                  [&](int rr, int c, float s) { dx1[rr * H + c] = s; });
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      float m = 1.f;
      if (g < R) {
        st(ds1m + row0 * H + i, dx1[i]);
        if (drop.on) m = mval(drop, S_STACK_MID, 0, t, g, H, j);
      }
      dh0[i] += drop.on ? dx1[i] * m : dx1[i];
    }
    __syncthreads();

    // Layer 0 backward.
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H;
      const float* zr = z0 + rr * H4;
      const Gates q = {zr[j], zr[H + j], zr[2 * H + j], zr[3 * H + j]};
      dc0[i] = cell_bwd<T>(q, cp0[i], tc0[i], dh0[i], dc0[i], hard,
                           dz + rr * l4, H, j);
    }
    __syncthreads();
    for (int i = tid; i < RB * H4; i += nt)
      if (g0 + i / H4 < R)
        st(dz0t + row0 * H4 + i, dz[(i / H4) * l4 + i % H4]);
    matvec<T, RB>(dz, l4, H4, u0t, H, scr,
                  [&](int rr, int c, float s) { dh0[rr * H + c] = s; });
    matvec<T, RB>(dz, l4, H4, w0t, F, scr,
                  [&](int rr, int c, float s) { dxo[rr * F + c] = s; });
    for (int i = tid; i < RB * F; i += nt)
      if (g0 + i / F < R) st(dx0 + row0 * F + i, dxo[i]);
    __syncthreads();
  }
  for (int i = tid; i < RB * H; i += nt) {
    const int g = g0 + i / H;
    if (g < R) {
      const size_t o = (size_t)g * H + i % H;
      dh00[o] = dh0[i];
      dc00[o] = dc0[i];
      dh10[o] = dh1[i];
      dc10[o] = dc1[i];
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
int stack_fwd(void* const* p, StackDims d, Drop drop, int hard,
              cudaStream_t st) {
  const int H4 = 4 * d.H, nt = threads_for(H4), RB = FWD_RB;
  const size_t smem = sizeof(float) *
      (RB * (padk(d.F) + 3 * padk(d.H) + 2 * d.H + H4) + (size_t)nt * RB);
  auto kern = stack_fwd_kernel<T, FWD_RB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<(d.R + RB - 1) / RB, nt, smem, st>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const float*)p[8], (const float*)p[9], (const float*)p[10],
      (const float*)p[11], (T*)p[12], (T*)p[13], (T*)p[14], (T*)p[15],
      (float*)p[16], (float*)p[17], (float*)p[18], (float*)p[19], d, drop,
      hard);
  return (int)cudaGetLastError();
}

template <typename T>
int stack_bwd(void* const* p, StackDims d, Drop drop, int hard,
              cudaStream_t st) {
  const int H4 = 4 * d.H, nt = threads_for(H4), RB = BWD_RB;
  const size_t smem =
      sizeof(float) * (RB * (padk(d.F) + 3 * padk(d.H) + padk(H4) +
                             9 * d.H + 2 * H4 + d.F) +
                       (size_t)nt * RB);
  auto kern = stack_bwd_kernel<T, BWD_RB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<(d.R + RB - 1) / RB, nt, smem, st>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const T*)p[8], (const T*)p[9], (const T*)p[10], (const T*)p[11],
      (const T*)p[12], (const T*)p[13], (const T*)p[14], (const T*)p[15],
      (const T*)p[16], (const T*)p[17], (const float*)p[18],
      (const float*)p[19], (T*)p[20], (T*)p[21], (T*)p[22], (T*)p[23],
      (T*)p[24], (float*)p[25], (float*)p[26], (float*)p[27], (float*)p[28],
      d, drop, hard);
  return (int)cudaGetLastError();
}

}  // namespace biax

// Matrices in the layout of the compute dtype (see matvec in
// biax_common.cuh); b0, b1 in T; initial states float32.  Pointers, in
// order: x0 s1m w0 b0 b1 u0 w1 u1 h00 c00 h10 c10 | hs0 cs0 hs1 cs1 (hs0,
// cs0, cs1 may be null) h0T c0T h1T c1T.
extern "C" int lstm2_fwd(
    int bf16, void* x0, void* s1m, void* w0, void* b0, void* b1, void* u0,
    void* w1, void* u1, void* h00, void* c00, void* h10, void* c10, void* hs0,
    void* cs0, void* hs1, void* cs1, void* h0T, void* c0T, void* h1T,
    void* c1T, int S, int R, int F, int H, unsigned seed, unsigned thr,
    float scale, int dropout, int hard, void* stream) {
  using namespace biax;
  void* const p[] = {x0,  s1m, w0,  b0,  b1,  u0,  w1,  u1,  h00, c00,
                     h10, c10, hs0, cs0, hs1, cs1, h0T, c0T, h1T, c1T};
  const StackDims d = {S, R, F, H};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return stack_fwd<biax::bf16>(p, d, drop, hard, st);
  return stack_fwd<float>(p, d, drop, hard, st);
}

// Pointers, in order: x0 s1m w0 b0 b1 u0 w1 u1 w0t u0t w1t u1t hs0prev cs0
// hs1prev cs1 hs0 dhs1 dc0T dc1T | dx0 ds1m x1 dz0 dz1 dh00 dc00 dh10 dc10.
extern "C" int lstm2_bwd(
    int bf16, void* x0, void* s1m, void* w0, void* b0, void* b1, void* u0,
    void* w1, void* u1, void* w0t, void* u0t, void* w1t, void* u1t,
    void* hs0p, void* cs0, void* hs1p, void* cs1, void* hs0, void* dhs1,
    void* dc0T, void* dc1T, void* dx0, void* ds1m, void* x1, void* dz0,
    void* dz1, void* dh00, void* dc00, void* dh10, void* dc10, int S, int R,
    int F, int H, unsigned seed, unsigned thr, float scale, int dropout,
    int hard, void* stream) {
  using namespace biax;
  void* const p[] = {x0,   s1m,  w0,   b0,   b1,   u0,  w1,   u1,
                     w0t,  u0t,  w1t,  u1t,  hs0p, cs0, hs1p, cs1,
                     hs0,  dhs1, dc0T, dc1T, dx0,  ds1m, x1,  dz0,
                     dz1,  dh00, dc00, dh10, dc10};
  const StackDims d = {S, R, F, H};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return stack_bwd<biax::bf16>(p, d, drop, hard, st);
  return stack_bwd<float>(p, d, drop, hard, st);
}
