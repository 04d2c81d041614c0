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
// real floor is the chain of 128 dependent steps, each a product with all
// 1.8 MB of the stack's weights.
//
// Design (simple first).  One block owns RB rows for the whole scan (RB = 8
// forward, 6 backward: 96 and 128 blocks at the flagship, one wave on the
// 132 SMs) and keeps h, c, the gates and the layer inputs in shared memory;
// the weights stream from L2 every step.  Fewer, larger blocks move fewer
// bytes from L2 but lengthen each block's chain of dependent steps: 16 rows
// per block (48 blocks) made the forward slower on the card, not faster.  In bfloat16 each warp multiplies
// 16 gate columns by the block's rows with tensor-core mma.sync (float32
// accumulation); in float32 a thread owns a gate column and accumulates its
// rows with FMAs on the CUDA cores.  Barriers separate the stages of a
// step.  Blocks never talk to each other, so the weight gradients, which
// the TPU kernel summed in VMEM across its sequential grid, are a second,
// deterministic reduction over the dz tapes.  wgmma, TMA, weights resident
// in a cluster's shared memory are later work.

#include "biax_common.cuh"

namespace biax {

struct TimeDims { int T, N, B, F, H, k; };

template <typename T, int RB>
__global__ void __launch_bounds__(1024) time_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ s0,
    const T* __restrict__ s1, const T* __restrict__ w0,
    const T* __restrict__ b0, const T* __restrict__ b1,
    const T* __restrict__ u0, const T* __restrict__ w1,
    const T* __restrict__ u1, T* hs0, T* cs0, T* hs1, T* cs1, TimeDims d,
    Drop drop, int hard) {
  extern __shared__ float sm[];
  const int F = d.F, H = d.H, H4 = 4 * H, R = d.N * d.B;
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
  for (int i = tid; i < RB * (lF + 3 * lH + 2 * H + H4); i += nt) sm[i] = 0.f;
  __syncthreads();
  for (int t = 0; t < d.T; ++t) {
    for (int i = tid; i < RB * F; i += nt) {
      const int rr = i / F, f = i % F, g = g0 + rr;
      float v = 0.f;
      if (g < R) {
        const RowPos p = row_pos(g, d.B, d.k);
        float s = ld(s0 + ((size_t)t * d.B + p.b) * F + f);
        if (drop.on) s = mul_t<T>(s, mval(drop, S_STYLE0, p.j, t, p.r, F, f));
        v = add_t<T>(ld(x + ((size_t)t * R + g) * F + f), s);
      }
      xin[rr * lF + f] = v;
    }
    __syncthreads();
    preact<T, RB>(xin, lF, F, w0, b0, h0, lH, H, u0, z, scr);
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      const Gates q = gates<T>(z + rr * H4, H, j, hard);
      const float cp = c0[i];
      float hn;
      c0[i] = cell<T>(q, cp, &hn);
      h0[rr * lH + j] = hn;
      float xv = 0.f;
      if (g < R) {
        const size_t o = ((size_t)t * R + g) * H + j;
        if (cs0) st(cs0 + o, cp);
        if (hs0) st(hs0 + o, hn);
        const RowPos p = row_pos(g, d.B, d.k);
        float s = ld(s1 + ((size_t)t * d.B + p.b) * H + j);
        float hv = hn;
        if (drop.on) {
          hv = mul_t<T>(hn, mval(drop, S_MID, p.j, t, p.r, H, j));
          s = mul_t<T>(s, mval(drop, S_STYLE1, p.j, t, p.r, H, j));
        }
        xv = add_t<T>(hv, s);
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
      c1[i] = cell<T>(q, cp, &hn);
      h1[rr * lH + j] = hn;
      if (g < R) {
        const size_t o = ((size_t)t * R + g) * H + j;
        if (cs1) st(cs1 + o, cp);
        st(hs1 + o, hn);
      }
    }
    __syncthreads();
  }
}

template <typename T, int RB>
__global__ void __launch_bounds__(1024) time_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ s0,
    const T* __restrict__ s1, const T* __restrict__ w0,
    const T* __restrict__ b0, const T* __restrict__ b1,
    const T* __restrict__ u0, const T* __restrict__ w1,
    const T* __restrict__ u1, const T* __restrict__ w0t,
    const T* __restrict__ u0t, const T* __restrict__ w1t,
    const T* __restrict__ u1t, const T* __restrict__ hs0,
    const T* __restrict__ cs0, const T* __restrict__ hs1,
    const T* __restrict__ cs1, const T* __restrict__ dhs1, T* dx,
    float* ds0r, float* ds1r, T* xtot, T* x1tape, T* dz0t, T* dz1t,
    TimeDims d, Drop drop, int hard) {
  extern __shared__ float sm[];
  const int F = d.F, H = d.H, H4 = 4 * H, R = d.N * d.B;
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
  for (int t = d.T - 1; t >= 0; --t) {
    // Recompute the forward of step t from the tapes.
    for (int i = tid; i < RB * F; i += nt) {
      const int rr = i / F, f = i % F, g = g0 + rr;
      float v = 0.f;
      if (g < R) {
        const RowPos p = row_pos(g, d.B, d.k);
        float s = ld(s0 + ((size_t)t * d.B + p.b) * F + f);
        if (drop.on) s = mul_t<T>(s, mval(drop, S_STYLE0, p.j, t, p.r, F, f));
        v = add_t<T>(ld(x + ((size_t)t * R + g) * F + f), s);
        st(xtot + ((size_t)t * R + g) * pad8(F) + f, v);
      }
      xin[rr * lF + f] = v;
    }
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      float a = 0.f, b = 0.f, c = 0.f, e = 0.f;
      if (g < R) {
        const size_t o = ((size_t)t * R + g) * H + j;
        if (t > 0) {
          a = ld(hs0 + o - (size_t)R * H);
          b = ld(hs1 + o - (size_t)R * H);
        }
        c = ld(cs0 + o);
        e = ld(cs1 + o);
      }
      hp0[rr * lH + j] = a;
      hp1[rr * lH + j] = b;
      cp0[i] = c;
      cp1[i] = e;
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
        const size_t o = ((size_t)t * R + g) * H + j;
        const RowPos p = row_pos(g, d.B, d.k);
        float hv = ld(hs0 + o);
        float s = ld(s1 + ((size_t)t * d.B + p.b) * H + j);
        if (drop.on) {
          hv = mul_t<T>(hv, mval(drop, S_MID, p.j, t, p.r, H, j));
          s = mul_t<T>(s, mval(drop, S_STYLE1, p.j, t, p.r, H, j));
        }
        xv = add_t<T>(hv, s);
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
      const int rr = i / H, j = i % H, g = g0 + rr;
      const float* zr = z1 + rr * H4;
      const Gates q = {zr[j], zr[H + j], zr[2 * H + j], zr[3 * H + j]};
      float dh = dh1[i];
      if (g < R) dh += ld(dhs1 + ((size_t)t * R + g) * H + j);
      dc1[i] = cell_bwd<T>(q, cp1[i], tc1[i], dh, dc1[i], hard,
                           dz + rr * l4, H, j);
    }
    __syncthreads();
    for (int i = tid; i < RB * H4; i += nt) {
      const int g = g0 + i / H4;
      if (g < R)
        st(dz1t + (size_t)t * R * H4 + (size_t)g0 * H4 + i,
           dz[(i / H4) * l4 + i % H4]);
    }
    matvec<T, RB>(dz, l4, H4, u1t, H, scr,
                  [&](int rr, int c, float s) { dh1[rr * H + c] = s; });
    matvec<T, RB>(dz, l4, H4, w1t, H, scr,
                  [&](int rr, int c, float s) { dx1[rr * H + c] = s; });
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      float m1 = 1.f, mm = 1.f;
      if (g < R) {
        if (drop.on) {
          const RowPos p = row_pos(g, d.B, d.k);
          m1 = mval(drop, S_STYLE1, p.j, t, p.r, H, j);
          mm = mval(drop, S_MID, p.j, t, p.r, H, j);
        }
        ds1r[((size_t)t * R + g) * H + j] = drop.on ? dx1[i] * m1 : dx1[i];
      }
      dh0[i] += drop.on ? dx1[i] * mm : dx1[i];
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
    for (int i = tid; i < RB * H4; i += nt) {
      const int g = g0 + i / H4;
      if (g < R)
        st(dz0t + (size_t)t * R * H4 + (size_t)g0 * H4 + i,
           dz[(i / H4) * l4 + i % H4]);
    }
    matvec<T, RB>(dz, l4, H4, u0t, H, scr,
                  [&](int rr, int c, float s) { dh0[rr * H + c] = s; });
    matvec<T, RB>(dz, l4, H4, w0t, F, scr,
                  [&](int rr, int c, float s) { dxo[rr * F + c] = s; });
    for (int i = tid; i < RB * F; i += nt) {
      const int rr = i / F, f = i % F, g = g0 + rr;
      if (g < R) {
        const size_t o = ((size_t)t * R + g) * F + f;
        st(dx + o, dxo[i]);
        float m0 = 1.f;
        if (drop.on) {
          const RowPos p = row_pos(g, d.B, d.k);
          m0 = mval(drop, S_STYLE0, p.j, t, p.r, F, f);
        }
        ds0r[o] = drop.on ? dxo[i] * m0 : dxo[i];
      }
    }
    __syncthreads();
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

constexpr int FWD_RB = 8;   // 96 blocks at the flagship
constexpr int BWD_RB = 6;   // 128 blocks: one wave on 132 SMs

inline int threads_for(int H4) {
  const int nt = ((H4 + 31) / 32) * 32;
  return nt > 1024 ? 1024 : nt;
}

template <typename T>
int time_fwd(const void* x, const void* s0, const void* s1, const void* w0,
             const void* b0, const void* b1, const void* u0, const void* w1,
             const void* u1, void* hs0, void* cs0, void* hs1, void* cs1,
             TimeDims d, Drop drop, int hard, cudaStream_t st) {
  const int R = d.N * d.B, H4 = 4 * d.H, RB = FWD_RB;
  const int nt = threads_for(H4);
  // The forward's products never split K (blockDim <= 4H) unless 4H < 32.
  const size_t smem = sizeof(float) *
      (RB * (padk(d.F) + 3 * padk(d.H) + 2 * d.H + H4) +
       (H4 < 32 ? nt * RB : 0));
  auto kern = time_fwd_kernel<T, FWD_RB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<(R + RB - 1) / RB, nt, smem, st>>>(
      (const T*)x, (const T*)s0, (const T*)s1, (const T*)w0, (const T*)b0,
      (const T*)b1, (const T*)u0, (const T*)w1, (const T*)u1, (T*)hs0,
      (T*)cs0, (T*)hs1, (T*)cs1, d, drop, hard);
  return (int)cudaGetLastError();
}

template <typename T>
int time_bwd(void* const* p, TimeDims d, Drop drop, int hard,
             cudaStream_t st) {
  const int R = d.N * d.B, H4 = 4 * d.H, RB = BWD_RB;
  const int nt = threads_for(H4);
  const size_t smem =
      sizeof(float) * (RB * (padk(d.F) + 3 * padk(d.H) + padk(H4) +
                             9 * d.H + 2 * H4 + d.F) +
                       nt * RB);
  auto kern = time_bwd_kernel<T, BWD_RB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<(R + RB - 1) / RB, nt, smem, st>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const T*)p[8], (const T*)p[9], (const T*)p[10], (const T*)p[11],
      (const T*)p[12], (const T*)p[13], (const T*)p[14], (const T*)p[15],
      (const T*)p[16], (const T*)p[17], (T*)p[18], (float*)p[19],
      (float*)p[20], (T*)p[21], (T*)p[22], (T*)p[23], (T*)p[24], d, drop,
      hard);
  return (int)cudaGetLastError();
}

}  // namespace biax

extern "C" int biax_time_fwd(int bf16, const void* x, const void* s0,
                             const void* s1, const void* w0, const void* b0,
                             const void* b1, const void* u0, const void* w1,
                             const void* u1, void* hs0, void* cs0, void* hs1,
                             void* cs1, int T, int N, int B, int F, int H,
                             int k, unsigned seed, unsigned thr, float scale,
                             int dropout, int hard, void* stream) {
  using namespace biax;
  const TimeDims d = {T, N, B, F, H, k};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return time_fwd<biax::bf16>(x, s0, s1, w0, b0, b1, u0, w1, u1, hs0, cs0,
                                hs1, cs1, d, drop, hard, st);
  return time_fwd<float>(x, s0, s1, w0, b0, b1, u0, w1, u1, hs0, cs0, hs1,
                         cs1, d, drop, hard, st);
}

// Pointers, in order: x s0 s1 w0 b0 b1 u0 w1 u1 w0t u0t w1t u1t hs0 cs0 hs1
// cs1 dhs1 | dx ds0rows ds1rows xtot x1 dz0 dz1.
extern "C" int biax_time_bwd(
    int bf16, void* x, void* s0, void* s1, void* w0, void* b0, void* b1,
    void* u0, void* w1, void* u1, void* w0t, void* u0t, void* w1t, void* u1t,
    void* hs0, void* cs0, void* hs1, void* cs1, void* dhs1, void* dx,
    void* ds0r, void* ds1r, void* xtot, void* x1, void* dz0, void* dz1,
    int T, int N, int B, int F, int H, int k, unsigned seed, unsigned thr,
    float scale, int dropout, int hard, void* stream) {
  using namespace biax;
  void* const p[] = {x,   s0,  s1,  w0,   b0,  b1,   u0,   w1,   u1,
                     w0t, u0t, w1t, u1t,  hs0, cs0,  hs1,  cs1,  dhs1,
                     dx,  ds0r, ds1r, xtot, x1, dz0, dz1};
  const TimeDims d = {T, N, B, F, H, k};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return time_bwd<biax::bf16>(p, d, drop, hard, st);
  return time_bwd<float>(p, d, drop, hard, st);
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
