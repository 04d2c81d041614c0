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
// Both directions run in passes, the time stack's design (biax_time.cu)
// with the pitches as the scanned axis, because only one product carries
// from pitch to pitch: h U in the forward, dh <- dz U^T in the backward.
//
// Forward, in seven passes.  x W0 depends only on the inputs, x1 W1 only
// on layer 0's h at the same pitch, and the heads only on layer 1's h at
// that pitch.  (1) The prologue's first part forms xtot; (2) a tiled GEMM
// forms layer 0's input pre-activations P = (xtot W0 -> T) + b0 for all
// N T B rows at once (EPI_IN, one float32 sum over the Ht and C columns);
// (3) the layer-0 scan runs the cell forward with one h U0 product a pitch
// and writes hs0 (always: pass 4 reads it) and cs0 (with tapes); (4) the
// prologue's second part forms x1 from hs0; (5) a GEMM forms layer 1's P
// into the same buffer; (6) the layer-1 scan writes hs1 (always: pass 7
// reads it) and cs1; (7) the heads form out from hs1, a warp a row.
//
// Backward, in seven passes: only dh <- dz U^T carries from pitch to
// pitch; the recomputed gates and the heads' backward depend only on the
// forward's tapes, dx1 = dz1 W1^T feeds layer 0 at the same pitch and
// dx = dz0 W0^T nothing later.  (1) The whole prologue forms the layer
// inputs xtot and x1, the heads' input h1d, the heads' dz and layer 1's
// external gradient ext1; (2) a tiled GEMM forms both layers'
// pre-activations z over all N T B rows; (3) the layer-1 scan, reversed
// over the pitches, with ext1; (4) a GEMM forms dx1 = dz1 W1^T with the
// style-1 rows and the mid term in its epilogue; (5) the layer-0 scan with
// the mid term; (6) a GEMM forms dx = dz0 W0^T and scatters dht, dch and
// the style-0 rows (EPI_NOTE_DX); (7) biax_wgrad reduces the weight
// gradients and `biax_note_ds` sums the style rows over the pitches.
//
// The GEMMs and scans are biax_passes.cuh's with (S, A) = (N, T).  In
// bfloat16 the scans keep U (H x 4H = 128 KB at H = 128) resident in one
// block's shared memory (a cluster of one block), 16 rows a block: 128
// blocks at the flagship, one wave; in float32 they stream U from L2.

#include "biax_passes.cuh"

namespace biax {

struct NoteDims { int T, N, B, Ht, C, H, k; };

// The prologue of both directions for every (pitch, row) m = n R + g, with
// the Pallas kernel's cast points; `parts` selects what it forms:
// PRO_XTOT: xtot[m] = (ht m_in + s0t m_style0) ++ (ch + s0c m_style0c),
// D = Ht + C columns, padded to pad8(D) with zeros;
// PRO_X1: x1[m] = hs0 m_mid + s1 m_style1 (padded to pad8(H));
// PRO_HEADS, the heads' backward: h1d[m] = hs1 m_out; the heads' dz
// (float32) from the head pre-activation h1d Wh + bh (float32, a warp per
// head): dout sigma (1 - sigma) for play and replay, dout for volume; and
// layer 1's external gradient ext1 = (sum_c (dz_c -> T) Wh[j][c]) m_out
// (float32).  The forward runs PRO_XTOT and PRO_X1 as its passes 1 and 4,
// the backward all three parts as its pass 1.  One block of 128 threads a
// row.
template <typename T>
__global__ void __launch_bounds__(128) note_prologue_kernel(
    const T* __restrict__ ht, const T* __restrict__ ch,
    const T* __restrict__ s0, const T* __restrict__ s1,
    const T* __restrict__ hs0, const T* __restrict__ hs1,
    const T* __restrict__ wh, const float* __restrict__ bh,
    const float* __restrict__ dout, T* __restrict__ xtot,
    T* __restrict__ x1, T* __restrict__ h1d, float* __restrict__ dzh,
    float* __restrict__ ext1, NoteDims d, Drop drop, int parts) {
  extern __shared__ float hrow[];   // [H] the row's h1d, then its 3 dz
  const int Ht = d.Ht, C = d.C, D = Ht + C, H = d.H, R = d.T * d.B;
  const int lx = pad8(D), l1 = pad8(H);
  const int m = blockIdx.x, n = m / R, g = m % R;
  const RowPos p = row_pos(g, d.B, d.k);
  const int tid = threadIdx.x, nt = blockDim.x;
  if (parts & PRO_XTOT) {
    for (int col = tid; col < lx; col += nt) {
      float v = 0.f;
      if (col < D) {
        float s = ld(s0 + (size_t)g * D + col);
        if (col < Ht) {
          float xt =
              ld(ht + (((size_t)p.a * d.N + n) * d.B + p.b) * Ht + col);
          if (drop.on) {
            xt = mul_t<T>(xt, mval(drop, S_IN, p.j, n, p.r, Ht, col));
            s = mul_t<T>(s, mval(drop, S_STYLE0, p.j, n, p.r, Ht, col));
          }
          v = add_t<T>(xt, s);
        } else {
          const int c = col - Ht;
          if (drop.on)
            s = mul_t<T>(s, mval(drop, S_STYLE0C, p.j, n, p.r, C, c));
          v = add_t<T>(ld(ch + (size_t)m * C + c), s);
        }
      }
      st(xtot + (size_t)m * lx + col, v);
    }
  }
  // x1 and the heads' input in one loop, so that their loads are in
  // flight together when the backward forms both.
  const bool px1 = parts & PRO_X1, heads = parts & PRO_HEADS;
  for (int j = tid; (px1 || heads) && j < l1; j += nt) {
    float xv = 0.f;
    if (j < H) {
      const size_t o = (size_t)m * H + j;
      if (px1) {
        float hv = ld(hs0 + o), s = ld(s1 + (size_t)g * H + j);
        if (drop.on) {
          hv = mul_t<T>(hv, mval(drop, S_MID, p.j, n, p.r, H, j));
          s = mul_t<T>(s, mval(drop, S_STYLE1, p.j, n, p.r, H, j));
        }
        xv = add_t<T>(hv, s);
      }
      if (heads) {
        float hd = ld(hs1 + o);
        if (drop.on) hd = mul_t<T>(hd, mval(drop, S_OUT, p.j, n, p.r, H, j));
        st(h1d + o, hd);
        hrow[j] = hd;
      }
    }
    if (px1) st(x1 + (size_t)m * l1 + j, xv);
  }
  if (!heads) return;
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

// Forward 7. The heads of every row m: h1d = hs1 m_out (T), z_c = h1d
// Wh[:, c] + bh[c] in float32, out = sigmoid(z_play, z_replay -> T) ++
// z_volume.  A warp a row, HEADS_ROWS rows a block: lane l sums
// j = l, l + 32, .. with fmaf and the warp adds the lanes' sums by xor
// shuffles, the prologue's order (where a warp makes one head), so out
// equals the sigmoid the backward's prologue recomputes, bit for bit.
constexpr int HEADS_ROWS = 8;

template <typename T>
__global__ void __launch_bounds__(32 * HEADS_ROWS) note_heads_kernel(
    const T* __restrict__ hs1, const T* __restrict__ wh,
    const float* __restrict__ bh, float* __restrict__ out, NoteDims d,
    Drop drop) {
  const int H = d.H, R = d.T * d.B, lane = threadIdx.x & 31;
  const int m = blockIdx.x * HEADS_ROWS + (threadIdx.x >> 5);
  if (m >= d.N * R) return;
  const int n = m / R;
  const RowPos p = row_pos(m % R, d.B, d.k);
  float acc[3] = {0.f, 0.f, 0.f};
  for (int j = lane; j < H; j += 32) {
    float hd = ld(hs1 + (size_t)m * H + j);
    if (drop.on) hd = mul_t<T>(hd, mval(drop, S_OUT, p.j, n, p.r, H, j));
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = fmaf(hd, ld(wh + j * 3 + c), acc[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    for (int off = 16; off > 0; off >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  if (lane < 3) {
    const float zc = (lane == 0 ? acc[0] : lane == 1 ? acc[1] : acc[2]) +
                     bh[lane];
    out[(size_t)m * 3 + lane] = lane < 2 ? sigmoid_t<T>(rnd<T>(zc)) : zc;
  }
}

// Backward 7. The style gradient of the note stack: out[g][c] = the sum of
// rows [n][g][c] over the pitches in the order n = N - 1 .. 0, float32,
// the order in which the TPU kernel accumulates it (no per-tile rounding).
__global__ void note_ds_kernel(const float* __restrict__ rows, int N, int R,
                               int W, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t RW = (size_t)R * W;
  if (i >= RW) return;
  float tot = 0.f;
  for (int n = N - 1; n >= 0; --n) tot += rows[(size_t)n * RW + i];
  out[i] = tot;
}

}  // namespace biax

// The passes, launched in order by ops/biax.py::biax_note_fwd and
// biax_note_bwd.
// The prologue (`parts`, see note_prologue_kernel) of every row m of
// [N R]: xtot [N R][pad8(Ht + C)] from ht, ch and s0; x1 [N R][pad8(H)]
// from hs0 and s1; the heads' backward: h1d [N R][H], dzh [N R][3] and
// ext1 [N R][H] (both float32) from hs1, wh, bh and dout (both float32).
// Pointers a part does not read or write may be null.
extern "C" int biax_note_prologue(
    int bf16, int parts, const void* ht, const void* ch, const void* s0,
    const void* s1, const void* hs0, const void* hs1, const void* wh,
    const float* bh, const float* dout, void* xtot, void* x1, void* h1d,
    float* dzh, float* ext1, int T, int N, int B, int Ht, int C, int H,
    int k, unsigned seed, unsigned thr, float scale, int dropout,
    void* stream) {
  using namespace biax;
  const NoteDims d = {T, N, B, Ht, C, H, k};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = N * T * B;
  const size_t smem = sizeof(float) * (H + 3);
  if (bf16)
    note_prologue_kernel<biax::bf16><<<blocks, 128, smem, st>>>(
        (const biax::bf16*)ht, (const biax::bf16*)ch, (const biax::bf16*)s0,
        (const biax::bf16*)s1, (const biax::bf16*)hs0, (const biax::bf16*)hs1,
        (const biax::bf16*)wh, bh, dout, (biax::bf16*)xtot, (biax::bf16*)x1,
        (biax::bf16*)h1d, dzh, ext1, d, drop, parts);
  else
    note_prologue_kernel<float><<<blocks, 128, smem, st>>>(
        (const float*)ht, (const float*)ch, (const float*)s0,
        (const float*)s1, (const float*)hs0, (const float*)hs1,
        (const float*)wh, bh, dout, (float*)xtot, (float*)x1, (float*)h1d,
        dzh, ext1, d, drop, parts);
  return (int)cudaGetLastError();
}

// Forward 2., 5. One layer's input pre-activations P [M][4H] (launch_in).
extern "C" int biax_note_fwd_in(int bf16, const void* xin, int ldx, int K,
                                const void* w, const void* bias, void* pre,
                                int M, int H, void* stream) {
  return biax::launch_in(bf16, xin, ldx, K, w, bias, pre, M, H,
                         (cudaStream_t)stream);
}

// Forward 3., 6. One layer's forward scan over the pitches
// (launch_fwd_scan).
extern "C" int biax_note_fwd_scan(int bf16, int cluster, const void* pre,
                                  void* hs, void* cs, const void* u, int T,
                                  int N, int B, int H, int k, int hard,
                                  unsigned long long* prof, void* stream) {
  const biax::PassDims d = {N, T, B, H, k};
  return biax::launch_fwd_scan(bf16, cluster, pre, hs, cs, u, d, hard, prof,
                               (cudaStream_t)stream);
}

// Forward 7. out [N R][3] (float32) from hs1, wh and bh (float32).
extern "C" int biax_note_heads(int bf16, const void* hs1, const void* wh,
                               const float* bh, float* out, int T, int N,
                               int B, int H, int k, unsigned seed,
                               unsigned thr, float scale, int dropout,
                               void* stream) {
  using namespace biax;
  const NoteDims d = {T, N, B, 0, 0, H, k};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (N * T * B + HEADS_ROWS - 1) / HEADS_ROWS;
  if (bf16)
    note_heads_kernel<biax::bf16><<<blocks, 32 * HEADS_ROWS, 0, st>>>(
        (const biax::bf16*)hs1, (const biax::bf16*)wh, bh, out, d, drop);
  else
    note_heads_kernel<float><<<blocks, 32 * HEADS_ROWS, 0, st>>>(
        (const float*)hs1, (const float*)wh, bh, out, d, drop);
  return (int)cudaGetLastError();
}

// Backward 2. One layer's pre-activations over all M = N R rows
// (launch_preact).
extern "C" int biax_note_bwd_preact(int bf16, const void* xin, int ldx,
                                    int K, const void* w, const void* bias,
                                    const void* hs, const void* u, void* z,
                                    int M, int R, int H, void* stream) {
  return biax::launch_preact(bf16, xin, ldx, K, w, bias, hs, u, z, M, R, H,
                             (cudaStream_t)stream);
}

// Backward 3., 5. One layer's reversed scan over the pitches
// (launch_scan); the step's dh adds ext_f: ext1 for layer 1, the mid term
// for layer 0.
extern "C" int biax_note_bwd_scan(int bf16, int cluster, void* z_dz,
                                  const void* cs, const float* ext_f,
                                  const void* u, int T, int N, int B, int H,
                                  int k, int hard, unsigned long long* prof,
                                  void* stream) {
  const biax::PassDims d = {N, T, B, H, k};
  return biax::launch_scan(bf16, cluster, z_dz, cs, nullptr, ext_f, u, d,
                           hard, prof, (cudaStream_t)stream);
}

// Backward 4., 6. The product dz [M][4H] W^T (wt = `_layout(W^T)`).
// layer 1 (Nout = H): out_a = style-1 rows, out_b = the mid term
// (float32).  layer 0 (Nout = Ht + C): dht [T, N, B, Ht] and dch [N R][C]
// (T), out_a = the style-0 rows [N R][Ht + C] (float32).
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

// Backward 7. out [R][W] = the rows [N][R][W] summed over the pitches
// (note_ds).
extern "C" int biax_note_ds(const float* rows, int N, int R, int W,
                            float* out, void* stream) {
  const size_t n = (size_t)R * W;
  biax::note_ds_kernel<<<(int)((n + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(rows, N, R, W, out);
  return (int)cudaGetLastError();
}
