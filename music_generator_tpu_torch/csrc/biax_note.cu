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
// The backward writes dht (into the time stack), dch, the style gradients
// and the dz, head-input and head-gradient tapes that biax_wgrad
// (biax_common.cuh) reduces into dW, dU, db, dWhead and dbhead.
//
// What bounds it on this card.  At the flagship shapes (T = 128, N = 48,
// B = 16, Ht = 256, C = 3, H = 128) the forward does 2 N T B (Ht + C + 3H)
// 4H = 65 GFLOP and the backward about 3x that (194 GFLOP) (the Pallas
// CostEstimates): 0.065 and 0.20 ms at the H100's 989 TFLOP/s bf16.  The
// bytes (about 150 MB for the forward) take 0.05 ms at 3.35 TB/s.  The real
// floor is the chain of 48 dependent pitches.
//
// Forward (simple first), as in biax_time.cu: one block owns RB = 8 rows
// for the whole scan (256 blocks; 16 rows per block was slower), state
// and gates in shared memory, weights streamed from L2 at every pitch,
// tensor-core mma.sync products in bfloat16 and CUDA-core FMAs in
// float32, warp reductions for the three heads.
//
// Backward, in seven passes, the time stack's design (biax_time.cu) with
// the pitches as the scanned axis: only dh <- dz U^T carries from pitch to
// pitch; the recomputed gates and the heads' backward depend only on the
// forward's tapes, dx1 = dz1 W1^T feeds layer 0 at the same pitch and
// dx = dz0 W0^T nothing later.  (1) An elementwise prologue forms the
// layer inputs xtot and x1, the heads' input h1d, the heads' dz and layer
// 1's external gradient ext1; (2) a tiled GEMM forms both layers'
// pre-activations z over all N T B rows; (3) the layer-1 scan, reversed
// over the pitches, with ext1; (4) a GEMM forms dx1 = dz1 W1^T with the
// style-1 rows and the mid term in its epilogue; (5) the layer-0 scan with
// the mid term; (6) a GEMM forms dx = dz0 W0^T and scatters dht, dch and
// the style-0 rows (EPI_NOTE_DX); (7) biax_wgrad reduces the weight
// gradients and `biax_note_ds` sums the style rows over the pitches.
// Passes 2-6 are biax_passes.cuh's with (S, A) = (N, T).  In bfloat16
// the scans keep U (H x 4H = 128 KB at H = 128) resident in one block's
// shared memory (a cluster of one block), 16 rows a block: 128 blocks at
// the flagship, one wave; in float32 they stream U^T from L2.

#include "biax_passes.cuh"

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

// ---------------------------------------------------------------------------
// The backward, in seven passes (see the note at the top; 2-6 in
// biax_passes.cuh with (S, A) = (N, T)).
// ---------------------------------------------------------------------------

// 1. Prologue and heads backward for every (pitch, row) m = n R + g, with
// the cast points of the forward: xtot[m] = (ht m_in + s0t m_style0) ++
// (ch + s0c m_style0c), D = Ht + C columns, padded to pad8(D) with zeros;
// x1[m] = hs0 m_mid + s1 m_style1 (padded to pad8(H)); h1d[m] = hs1 m_out;
// the heads' dz (float32) from the head pre-activation h1d Wh + bh:
// dout sigma (1 - sigma) for play and replay, dout for volume; and layer
// 1's external gradient ext1 = (sum_c (dz_c -> T) Wh[j][c]) m_out
// (float32).  One block of 128 threads a row; a warp per head.
template <typename T>
__global__ void __launch_bounds__(128) note_bwd_prologue_kernel(
    const T* __restrict__ ht, const T* __restrict__ ch,
    const T* __restrict__ s0, const T* __restrict__ s1,
    const T* __restrict__ hs0, const T* __restrict__ hs1,
    const T* __restrict__ wh, const float* __restrict__ bh,
    const float* __restrict__ dout, T* __restrict__ xtot,
    T* __restrict__ x1, T* __restrict__ h1d, float* __restrict__ dzh,
    float* __restrict__ ext1, NoteDims d, Drop drop) {
  extern __shared__ float hrow[];   // [H] the row's h1d, then its 3 dz
  const int Ht = d.Ht, C = d.C, D = Ht + C, H = d.H, R = d.T * d.B;
  const int lx = pad8(D), l1 = pad8(H);
  const int m = blockIdx.x, n = m / R, g = m % R;
  const RowPos p = row_pos(g, d.B, d.k);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int col = tid; col < lx; col += nt) {
    float v = 0.f;
    if (col < D) {
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
        v = add_t<T>(ld(ch + (size_t)m * C + c), s);
      }
    }
    st(xtot + (size_t)m * lx + col, v);
  }
  for (int j = tid; j < l1; j += nt) {
    float xv = 0.f;
    if (j < H) {
      const size_t o = (size_t)m * H + j;
      float hv = ld(hs0 + o), s = ld(s1 + (size_t)g * H + j), hd = ld(hs1 + o);
      if (drop.on) {
        hv = mul_t<T>(hv, mval(drop, S_MID, p.j, n, p.r, H, j));
        s = mul_t<T>(s, mval(drop, S_STYLE1, p.j, n, p.r, H, j));
        hd = mul_t<T>(hd, mval(drop, S_OUT, p.j, n, p.r, H, j));
      }
      xv = add_t<T>(hv, s);
      st(h1d + o, hd);
      hrow[j] = hd;
    }
    st(x1 + (size_t)m * l1 + j, xv);
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  if (warp < 3) {
    const int c = warp;
    float acc = 0.f;
    for (int j = lane; j < H; j += 32)
      acc = fmaf(hrow[j], ld(wh + j * 3 + c), acc);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const float zc = acc + bh[c];
      float dzc = dout[(size_t)m * 3 + c];
      if (c < 2) {
        const float sg = sigmoid_t<T>(rnd<T>(zc));
        dzc = dzc * sg * (1.f - sg);
      }
      dzh[(size_t)m * 3 + c] = dzc;
      hrow[H + c] = dzc;
    }
  }
  __syncthreads();
  for (int j = tid; j < H; j += nt) {
    float dhh = 0.f;
    for (int c = 0; c < 3; ++c)
      dhh = fmaf(rnd<T>(hrow[H + c]), ld(wh + j * 3 + c), dhh);
    if (drop.on) dhh *= mval(drop, S_OUT, p.j, n, p.r, H, j);
    ext1[(size_t)m * H + j] = dhh;
  }
}

// 7. The style gradient of the note stack: out[g][c] = the sum of rows
// [n][g][c] over the pitches in the order n = N - 1 .. 0, float32, the
// order in which the TPU kernel accumulates it (no per-tile rounding).
__global__ void note_ds_kernel(const float* __restrict__ rows, int N, int R,
                               int W, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t RW = (size_t)R * W;
  if (i >= RW) return;
  float tot = 0.f;
  for (int n = N - 1; n >= 0; --n) tot += rows[(size_t)n * RW + i];
  out[i] = tot;
}

constexpr int FWD_RB = 8;   // 256 blocks at the flagship

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

// The backward's passes, launched in order by ops/biax.py::biax_note_bwd.
// 1. xtot [N R][pad8(Ht + C)], x1 [N R][pad8(H)], h1d [N R][H], dzh
// [N R][3] (float32), ext1 [N R][H] (float32) from ht, ch, s0, s1, the
// tapes hs0, hs1, the heads' wh, bh (float32) and dout (float32).
extern "C" int biax_note_bwd_prologue(
    int bf16, const void* ht, const void* ch, const void* s0, const void* s1,
    const void* hs0, const void* hs1, const void* wh, const float* bh,
    const float* dout, void* xtot, void* x1, void* h1d, float* dzh,
    float* ext1, int T, int N, int B, int Ht, int C, int H, int k,
    unsigned seed, unsigned thr, float scale, int dropout, void* stream) {
  using namespace biax;
  const NoteDims d = {T, N, B, Ht, C, H, k};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = N * T * B;
  const size_t smem = sizeof(float) * (H + 3);
  if (bf16)
    note_bwd_prologue_kernel<biax::bf16><<<blocks, 128, smem, st>>>(
        (const biax::bf16*)ht, (const biax::bf16*)ch, (const biax::bf16*)s0,
        (const biax::bf16*)s1, (const biax::bf16*)hs0, (const biax::bf16*)hs1,
        (const biax::bf16*)wh, bh, dout, (biax::bf16*)xtot, (biax::bf16*)x1,
        (biax::bf16*)h1d, dzh, ext1, d, drop);
  else
    note_bwd_prologue_kernel<float><<<blocks, 128, smem, st>>>(
        (const float*)ht, (const float*)ch, (const float*)s0,
        (const float*)s1, (const float*)hs0, (const float*)hs1,
        (const float*)wh, bh, dout, (float*)xtot, (float*)x1, (float*)h1d,
        dzh, ext1, d, drop);
  return (int)cudaGetLastError();
}

// 2. One layer's pre-activations over all M = N R rows (launch_preact).
extern "C" int biax_note_bwd_preact(int bf16, const void* xin, int ldx,
                                    int K, const void* w, const void* bias,
                                    const void* hs, const void* u, void* z,
                                    int M, int R, int H, void* stream) {
  return biax::launch_preact(bf16, xin, ldx, K, w, bias, hs, u, z, M, R, H,
                             (cudaStream_t)stream);
}

// 3., 5. One layer's reversed scan over the pitches (launch_scan); the
// step's dh adds ext_f: ext1 for layer 1, the mid term for layer 0.
extern "C" int biax_note_bwd_scan(int bf16, int cluster, void* z_dz,
                                  const void* cs, const float* ext_f,
                                  const void* u, int T, int N, int B, int H,
                                  int k, int hard, unsigned long long* prof,
                                  void* stream) {
  const biax::PassDims d = {N, T, B, H, k};
  return biax::launch_scan(bf16, cluster, z_dz, cs, nullptr, ext_f, u, d,
                           hard, prof, (cudaStream_t)stream);
}

// 4., 6. The product dz [M][4H] W^T (wt = `_layout(W^T)`).  layer 1 (Nout
// = H): out_a = style-1 rows, out_b = the mid term (float32).  layer 0
// (Nout = Ht + C): dht [T, N, B, Ht] and dch [N R][C] (T), out_a = the
// style-0 rows [N R][Ht + C] (float32).
extern "C" int biax_note_bwd_dx(int bf16, int layer, const void* dz,
                                const void* wt, int M, int K, int Nout,
                                void* dht, void* dch, float* out_a,
                                float* out_b, int T, int N, int B, int Ht,
                                int H, int k, unsigned seed, unsigned thr,
                                float scale, int dropout, void* stream) {
  using namespace biax;
  const PassDims d = {N, T, B, H, k};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  return layer ? launch_dx<EPI_DX1>(bf16, dz, wt, M, K, Nout, nullptr, out_a,
                                    out_b, nullptr, 0, d, drop, st)
               : launch_dx<EPI_NOTE_DX>(bf16, dz, wt, M, K, Nout, dht, out_a,
                                        nullptr, dch, Ht, d, drop, st);
}

// 7. out [R][W] = the rows [N][R][W] summed over the pitches (note_ds).
extern "C" int biax_note_ds(const float* rows, int N, int R, int W,
                            float* out, void* stream) {
  const size_t n = (size_t)R * W;
  biax::note_ds_kernel<<<(int)((n + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(rows, N, R, W, out);
  return (int)cudaGetLastError();
}
