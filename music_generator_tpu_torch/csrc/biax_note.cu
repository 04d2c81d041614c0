// The note-axis training stack of DeepJ as CUDA kernels for Hopper
// (sm_90a): forward and backward of two stacked LSTM layers scanning the
// N = 48 pitches, with rows (t, b) over the 128 timesteps and the batch,
// and the fused output heads.
//
// Replaces music_generator_tpu/ops/pallas_biax.py: `_note_fwd_impl`
// (kernel `_note_fwd_kernel`) and `_note_bwd_impl` (kernel
// `_note_bwd_kernel`, custom VJP `_make_note_stack`).  Per pitch n and row:
// the time stack's output through its dropout mask (S_IN) + style-0 term
// (S_STYLE0), the shifted chosen note + its style-0 term (S_STYLE0C), the
// split projection (ht W0t + ch W0c, one float32 sum, -> T) + b0, layer 0,
// inter-layer dropout (S_MID) + style-1 term (S_STYLE1), layer 1, output
// dropout (S_OUT), then sigmoid(play, replay) ++ linear volume in float32.
// The backward recomputes the gates from the tapes, runs the heads
// backward, and writes dht (into the time stack), dch, the style gradients
// (accumulated in float32 by the block that owns the row, over all
// pitches), and the dz, head-input and head-gradient tapes that biax_wgrad
// (biax_common.cuh) reduces into dW, dU, db, dWhead and dbhead.
//
// What bounds it on this card.  At the flagship shapes (T = 128, N = 48,
// B = 16, Ht = 256, C = 3, H = 128) the forward does 2 N T B (Ht + C + 3H)
// 4H = 65 GFLOP and the backward about 3x that (194 GFLOP) (the Pallas
// CostEstimates): 0.065 and 0.20 ms at the H100's 989 TFLOP/s bf16.  The
// bytes (about 150 MB for the forward) take 0.05 ms at 3.35 TB/s.  The real
// floor is the chain of 48 dependent pitches, each a product with all the
// stack's weights (0.66 MB in bf16).
//
// Design (simple first), as in biax_time.cu: one block owns RB = 8 rows
// for the whole scan (256 blocks; 16 rows per block was slower), state
// and gates in shared memory, weights streamed from L2, tensor-core
// mma.sync products in bfloat16 and CUDA-core FMAs in float32, warp
// reductions for the three heads.

#include "biax_common.cuh"

namespace biax {

struct NoteDims { int T, N, B, Ht, C, H, k; };

template <typename T, int RB>
__global__ void __launch_bounds__(1024) note_fwd_kernel(
    const T* __restrict__ ht, const T* __restrict__ ch,
    const T* __restrict__ s0, const T* __restrict__ s1,
    const T* __restrict__ w0, const T* __restrict__ b0,
    const T* __restrict__ b1, const T* __restrict__ u0,
    const T* __restrict__ w1, const T* __restrict__ u1,
    const T* __restrict__ wh, const float* __restrict__ bh,
    float* __restrict__ out, T* hs0, T* cs0, T* hs1, T* cs1, NoteDims d,
    Drop drop, int hard) {
  extern __shared__ float sm[];
  const int Ht = d.Ht, C = d.C, D = Ht + C, H = d.H, H4 = 4 * H;
  const int R = d.T * d.B;
  const int lD = padk(D), lH = padk(H);
  // Product inputs (rows padded to 32 with zeros): xin, x1, h0, h1.
  float* xin = sm;
  float* x1 = xin + RB * lD;
  float* h0 = x1 + RB * lH;
  float* h1 = h0 + RB * lH;
  float* c0 = h1 + RB * lH;
  float* c1 = c0 + RB * H;
  float* z = c1 + RB * H;
  float* scr = z + RB * H4;
  const int tid = threadIdx.x, nt = blockDim.x, g0 = blockIdx.x * RB;
  const int lane = tid % 32, warp = tid / 32, nwarps = nt / 32;
  for (int i = tid; i < RB * (lD + 3 * lH + 2 * H + H4); i += nt) sm[i] = 0.f;
  __syncthreads();
  for (int n = 0; n < d.N; ++n) {
    for (int i = tid; i < RB * D; i += nt) {
      const int rr = i / D, col = i % D, g = g0 + rr;
      float v = 0.f;
      if (g < R) {
        const RowPos p = row_pos(g, d.B, d.k);
        float s = ld(s0 + (size_t)g * D + col);
        if (col < Ht) {
          float xt = ld(ht + (((size_t)p.a * d.N + n) * d.B + p.b) * Ht + col);
          if (drop.on) {
            xt = mul_t<T>(xt, mval(drop, S_IN, p.j, n, p.r, Ht, col));
            s = mul_t<T>(s, mval(drop, S_STYLE0, p.j, n, p.r, Ht, col));
          }
          v = add_t<T>(xt, s);
        } else {
          const int c = col - Ht;
          if (drop.on) s = mul_t<T>(s, mval(drop, S_STYLE0C, p.j, n, p.r, C, c));
          v = add_t<T>(ld(ch + ((size_t)n * R + g) * C + c), s);
        }
      }
      xin[rr * lD + col] = v;
    }
    __syncthreads();
    preact<T, RB>(xin, lD, D, w0, b0, h0, lH, H, u0, z, scr);
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      const Gates q = gates<T>(z + rr * H4, H, j, hard);
      const float cp = c0[i];
      float hn;
      c0[i] = cell<T>(q, cp, &hn);
      h0[rr * lH + j] = hn;
      float xv = 0.f;
      if (g < R) {
        const size_t o = ((size_t)n * R + g) * H + j;
        if (cs0) st(cs0 + o, cp);
        if (hs0) st(hs0 + o, hn);
        const RowPos p = row_pos(g, d.B, d.k);
        float s = ld(s1 + (size_t)g * H + j);
        float hv = hn;
        if (drop.on) {
          hv = mul_t<T>(hn, mval(drop, S_MID, p.j, n, p.r, H, j));
          s = mul_t<T>(s, mval(drop, S_STYLE1, p.j, n, p.r, H, j));
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
      float hd = hn;
      if (g < R) {
        const size_t o = ((size_t)n * R + g) * H + j;
        if (cs1) st(cs1 + o, cp);
        if (hs1) st(hs1 + o, hn);
        if (drop.on) {
          const RowPos p = row_pos(g, d.B, d.k);
          hd = mul_t<T>(hn, mval(drop, S_OUT, p.j, n, p.r, H, j));
        }
      }
      x1[rr * lH + j] = hd;             // the heads' input, h1 after S_OUT
    }
    __syncthreads();
    // Heads: one warp per (row, output), float32 sums.
    for (int it = warp; it < RB * 3; it += nwarps) {
      const int rr = it / 3, c = it % 3, g = g0 + rr;
      float acc = 0.f;
      for (int j = lane; j < H; j += 32)
        acc = fmaf(x1[rr * lH + j], ld(wh + j * 3 + c), acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0 && g < R) {
        const float zc = acc + bh[c];
        out[((size_t)n * R + g) * 3 + c] =
            c < 2 ? sigmoid_t<T>(rnd<T>(zc)) : zc;
      }
    }
    __syncthreads();
  }
}

template <typename T, int RB>
__global__ void __launch_bounds__(1024) note_bwd_kernel(
    const T* __restrict__ ht, const T* __restrict__ ch,
    const T* __restrict__ s0, const T* __restrict__ s1,
    const T* __restrict__ w0, const T* __restrict__ b0,
    const T* __restrict__ b1, const T* __restrict__ u0,
    const T* __restrict__ w1, const T* __restrict__ u1,
    const T* __restrict__ wh, const float* __restrict__ bh,
    const T* __restrict__ w0t, const T* __restrict__ u0t,
    const T* __restrict__ w1t, const T* __restrict__ u1t,
    const T* __restrict__ hs0, const T* __restrict__ cs0,
    const T* __restrict__ hs1, const T* __restrict__ cs1,
    const float* __restrict__ dout, T* dht, T* dch, float* ds0, float* ds1,
    T* xtot, T* x1tape, T* h1dtape, float* dzhtape, T* dz0t, T* dz1t,
    NoteDims d, Drop drop, int hard) {
  extern __shared__ float sm[];
  const int Ht = d.Ht, C = d.C, D = Ht + C, H = d.H, H4 = 4 * H;
  const int R = d.T * d.B;
  const int lD = padk(D), lH = padk(H), l4 = padk(H4);
  // Product inputs (rows padded to 32 with zeros): xin, x1, hp0, hp1, dz.
  float* xin = sm;
  float* x1 = xin + RB * lD;
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
  float* h1d = dx1 + RB * H;
  float* z0 = h1d + RB * H;
  float* z1 = z0 + RB * H4;
  float* dxo = z1 + RB * H4;
  float* dzh = dxo + RB * D;
  float* scr = dzh + RB * 4;
  const int tid = threadIdx.x, nt = blockDim.x, g0 = blockIdx.x * RB;
  const int lane = tid % 32, warp = tid / 32, nwarps = nt / 32;
  for (int i = tid; i < RB * (lD + 3 * lH + l4 + 10 * H + 2 * H4); i += nt)
    sm[i] = 0.f;
  __syncthreads();
  for (int n = d.N - 1; n >= 0; --n) {
    // Recompute the forward of pitch n from the tapes.
    for (int i = tid; i < RB * D; i += nt) {
      const int rr = i / D, col = i % D, g = g0 + rr;
      float v = 0.f;
      if (g < R) {
        const RowPos p = row_pos(g, d.B, d.k);
        float s = ld(s0 + (size_t)g * D + col);
        if (col < Ht) {
          float xt = ld(ht + (((size_t)p.a * d.N + n) * d.B + p.b) * Ht + col);
          if (drop.on) {
            xt = mul_t<T>(xt, mval(drop, S_IN, p.j, n, p.r, Ht, col));
            s = mul_t<T>(s, mval(drop, S_STYLE0, p.j, n, p.r, Ht, col));
          }
          v = add_t<T>(xt, s);
        } else {
          const int c = col - Ht;
          if (drop.on) s = mul_t<T>(s, mval(drop, S_STYLE0C, p.j, n, p.r, C, c));
          v = add_t<T>(ld(ch + ((size_t)n * R + g) * C + c), s);
        }
        st(xtot + ((size_t)n * R + g) * pad8(D) + col, v);
      }
      xin[rr * lD + col] = v;
    }
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      float a = 0.f, b = 0.f, c = 0.f, e = 0.f, hd = 0.f;
      if (g < R) {
        const size_t o = ((size_t)n * R + g) * H + j;
        if (n > 0) {
          a = ld(hs0 + o - (size_t)R * H);
          b = ld(hs1 + o - (size_t)R * H);
        }
        c = ld(cs0 + o);
        e = ld(cs1 + o);
        hd = ld(hs1 + o);
        if (drop.on) {
          const RowPos p = row_pos(g, d.B, d.k);
          hd = mul_t<T>(hd, mval(drop, S_OUT, p.j, n, p.r, H, j));
        }
        st(h1dtape + o, hd);
      }
      hp0[rr * lH + j] = a;
      hp1[rr * lH + j] = b;
      cp0[i] = c;
      cp1[i] = e;
      h1d[i] = hd;
    }
    __syncthreads();
    preact<T, RB>(xin, lD, D, w0, b0, hp0, lH, H, u0, z0, scr);
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
        const size_t o = ((size_t)n * R + g) * H + j;
        const RowPos p = row_pos(g, d.B, d.k);
        float hv = ld(hs0 + o);
        float s = ld(s1 + (size_t)g * H + j);
        if (drop.on) {
          hv = mul_t<T>(hv, mval(drop, S_MID, p.j, n, p.r, H, j));
          s = mul_t<T>(s, mval(drop, S_STYLE1, p.j, n, p.r, H, j));
        }
        xv = add_t<T>(hv, s);
        st(x1tape + o, xv);
      }
      x1[rr * lH + j] = xv;
    }
    // Heads backward: recompute the head pre-activations, then dz_head.
    for (int it = warp; it < RB * 3; it += nwarps) {
      const int rr = it / 3, c = it % 3, g = g0 + rr;
      float acc = 0.f;
      for (int j = lane; j < H; j += 32)
        acc = fmaf(h1d[rr * H + j], ld(wh + j * 3 + c), acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        float dzc = 0.f;
        if (g < R) {
          const size_t o = ((size_t)n * R + g) * 3 + c;
          const float zc = acc + bh[c];
          dzc = dout[o];
          if (c < 2) {
            const float sg = sigmoid_t<T>(rnd<T>(zc));
            dzc = dzc * sg * (1.f - sg);
          }
          dzhtape[o] = dzc;
        }
        dzh[rr * 4 + c] = dzc;
      }
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

    // Layer 1 backward, fed by the heads and the carry.
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      float dhh = 0.f;
      for (int c = 0; c < 3; ++c)
        dhh = fmaf(rnd<T>(dzh[rr * 4 + c]), ld(wh + j * 3 + c), dhh);
      if (drop.on && g < R) {
        const RowPos p = row_pos(g, d.B, d.k);
        dhh *= mval(drop, S_OUT, p.j, n, p.r, H, j);
      }
      const float* zr = z1 + rr * H4;
      const Gates q = {zr[j], zr[H + j], zr[2 * H + j], zr[3 * H + j]};
      dc1[i] = cell_bwd<T>(q, cp1[i], tc1[i], dh1[i] + dhh, dc1[i], hard,
                           dz + rr * l4, H, j);
    }
    __syncthreads();
    for (int i = tid; i < RB * H4; i += nt) {
      const int g = g0 + i / H4;
      if (g < R)
        st(dz1t + (size_t)n * R * H4 + (size_t)g0 * H4 + i,
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
          m1 = mval(drop, S_STYLE1, p.j, n, p.r, H, j);
          mm = mval(drop, S_MID, p.j, n, p.r, H, j);
        }
        ds1[(size_t)g * H + j] += drop.on ? dx1[i] * m1 : dx1[i];
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
        st(dz0t + (size_t)n * R * H4 + (size_t)g0 * H4 + i,
           dz[(i / H4) * l4 + i % H4]);
    }
    matvec<T, RB>(dz, l4, H4, u0t, H, scr,
                  [&](int rr, int c, float s) { dh0[rr * H + c] = s; });
    matvec<T, RB>(dz, l4, H4, w0t, D, scr,
                  [&](int rr, int c, float s) { dxo[rr * D + c] = s; });
    for (int i = tid; i < RB * D; i += nt) {
      const int rr = i / D, col = i % D, g = g0 + rr;
      if (g < R) {
        const RowPos p = row_pos(g, d.B, d.k);
        const float v = dxo[i];
        if (col < Ht) {
          float mi = 1.f, m0 = 1.f;
          if (drop.on) {
            mi = mval(drop, S_IN, p.j, n, p.r, Ht, col);
            m0 = mval(drop, S_STYLE0, p.j, n, p.r, Ht, col);
          }
          st(dht + (((size_t)p.a * d.N + n) * d.B + p.b) * Ht + col,
             drop.on ? v * mi : v);
          ds0[(size_t)g * D + col] += drop.on ? v * m0 : v;
        } else {
          const int c = col - Ht;
          float m0 = 1.f;
          if (drop.on) m0 = mval(drop, S_STYLE0C, p.j, n, p.r, C, c);
          st(dch + ((size_t)n * R + g) * C + c, v);
          ds0[(size_t)g * D + col] += drop.on ? v * m0 : v;
        }
      }
    }
    __syncthreads();
  }
}

constexpr int FWD_RB = 8;   // 256 blocks at the flagship
constexpr int BWD_RB = 8;   // 256 blocks

inline int threads_for(int H4) {
  const int nt = ((H4 + 31) / 32) * 32;
  return nt > 1024 ? 1024 : nt;
}

template <typename T>
int note_fwd(void* const* p, NoteDims d, Drop drop, int hard,
             cudaStream_t st) {
  const int R = d.T * d.B, H4 = 4 * d.H, D = d.Ht + d.C, RB = FWD_RB;
  const int nt = threads_for(H4);
  // The forward's products never split K (blockDim <= 4H) unless 4H < 32.
  const size_t smem = sizeof(float) *
      (RB * (padk(D) + 3 * padk(d.H) + 2 * d.H + H4) +
       (H4 < 32 ? nt * RB : 0));
  auto kern = note_fwd_kernel<T, FWD_RB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<(R + RB - 1) / RB, nt, smem, st>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const T*)p[8], (const T*)p[9], (const T*)p[10], (const float*)p[11],
      (float*)p[12], (T*)p[13], (T*)p[14], (T*)p[15], (T*)p[16], d, drop,
      hard);
  return (int)cudaGetLastError();
}

template <typename T>
int note_bwd(void* const* p, NoteDims d, Drop drop, int hard,
             cudaStream_t st) {
  const int R = d.T * d.B, H4 = 4 * d.H, D = d.Ht + d.C, RB = BWD_RB;
  const int nt = threads_for(H4);
  const size_t smem =
      sizeof(float) * (RB * (padk(D) + 3 * padk(d.H) + padk(H4) +
                             10 * d.H + 2 * H4 + D + 4) +
                       nt * RB);
  auto kern = note_bwd_kernel<T, BWD_RB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<(R + RB - 1) / RB, nt, smem, st>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const T*)p[8], (const T*)p[9], (const T*)p[10], (const float*)p[11],
      (const T*)p[12], (const T*)p[13], (const T*)p[14], (const T*)p[15],
      (const T*)p[16], (const T*)p[17], (const T*)p[18], (const T*)p[19],
      (const float*)p[20], (T*)p[21], (T*)p[22], (float*)p[23],
      (float*)p[24], (T*)p[25], (T*)p[26], (T*)p[27], (float*)p[28],
      (T*)p[29], (T*)p[30], d, drop, hard);
  return (int)cudaGetLastError();
}

}  // namespace biax

// Pointers, in order: ht ch s0 s1 w0 b0 b1 u0 w1 u1 wh bh(float32) | out
// (float32) hs0 cs0 hs1 cs1 (tapes, null for a forward without backward).
extern "C" int biax_note_fwd(
    int bf16, void* ht, void* ch, void* s0, void* s1, void* w0, void* b0,
    void* b1, void* u0, void* w1, void* u1, void* wh, void* bh, void* out,
    void* hs0, void* cs0, void* hs1, void* cs1, int T, int N, int B, int Ht,
    int C, int H, int k, unsigned seed, unsigned thr, float scale,
    int dropout, int hard, void* stream) {
  using namespace biax;
  void* const p[] = {ht, ch, s0, s1, w0, b0, b1, u0, w1, u1, wh, bh, out,
                     hs0, cs0, hs1, cs1};
  const NoteDims d = {T, N, B, Ht, C, H, k};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return note_fwd<biax::bf16>(p, d, drop, hard, st);
  return note_fwd<float>(p, d, drop, hard, st);
}

// Pointers, in order: ht ch s0 s1 w0 b0 b1 u0 w1 u1 wh bh w0t u0t w1t u1t
// hs0 cs0 hs1 cs1 dout | dht dch ds0 ds1 (float32, zeroed by the caller)
// xtot x1 h1d dzh (float32) dz0 dz1.
extern "C" int biax_note_bwd(
    int bf16, void* ht, void* ch, void* s0, void* s1, void* w0, void* b0,
    void* b1, void* u0, void* w1, void* u1, void* wh, void* bh, void* w0t,
    void* u0t, void* w1t, void* u1t, void* hs0, void* cs0, void* hs1,
    void* cs1, void* dout, void* dht, void* dch, void* ds0, void* ds1,
    void* xtot, void* x1, void* h1d, void* dzh, void* dz0, void* dz1, int T,
    int N, int B, int Ht, int C, int H, int k, unsigned seed, unsigned thr,
    float scale, int dropout, int hard, void* stream) {
  using namespace biax;
  void* const p[] = {ht,  ch,  s0,  s1,  w0,   b0,  b1,  u0,  w1,  u1, wh,
                     bh,  w0t, u0t, w1t, u1t,  hs0, cs0, hs1, cs1, dout,
                     dht, dch, ds0, ds1, xtot, x1,  h1d, dzh, dz0, dz1};
  const NoteDims d = {T, N, B, Ht, C, H, k};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return note_bwd<biax::bf16>(p, d, drop, hard, st);
  return note_bwd<float>(p, d, drop, hard, st);
}
