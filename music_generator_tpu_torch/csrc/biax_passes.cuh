// The pass machinery of the biaxial stacks (biax_time.cu, biax_note.cu)
// for Hopper (sm_90a): the bulk products with their epilogues, the forward
// scans of one layer and the two reversed scans of the backward, each
// streamed and with U resident in a thread-block cluster.
//
// Dims by role: the scanned axis S, the across axis A, and the rows
// R = A B of `row_pos`; pass row m = s R + g holds scan step s and row g.
// The time stack is (S, A) = (T, N), the note stack (S, A) = (N, T); under
// that relabelling a mask at site, tile, step, row and width is the same
// `mval` for both, so the scans and the epilogues serve both stacks.
//
// The products run over all S R rows at once: tensor-core mma.sync in
// bfloat16 (128 x 64 tiles, cp.async ring), CUDA-core FMAs in float32.
// EPI_IN forms a layer's input pre-activations (in W -> T) + b for the
// forward; EPI_PRE adds the recurrent term the backward recomputes;
// EPI_XW adds it to a given input projection (the single-layer recurrence's
// backward, lstm_recurrence.cu).  The forward scan carries only h U from
// step to step, the reversed scans only dh <- dz U^T.

#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "biax_common.cuh"

namespace biax {

struct PassDims { int S, A, B, H, k; };

inline int threads_for(int H4) {
  const int nt = ((H4 + 31) / 32) * 32;
  return nt > 1024 ? 1024 : nt;
}

// The bulk products C[M][N] = A B over all S R rows.  An operand pair: A
// [rows][lda] (K contiguous; row m reads row m - shift, zero before it;
// columns from K to lda hold zeros); B in the layout of T (`_layout`):
// bfloat16 [N][ldb = padk(K)] zero-padded, float32 [K][ldb = N].
template <typename T>
struct Operand {
  const T* A;
  int lda, shift, K;
  const T* B;
  int ldb;
};

enum { EPI_PRE = 0, EPI_DX1 = 1, EPI_DX0 = 2, EPI_NOTE_DX = 3, EPI_IN = 4,
       EPI_XW = 5, EPI_STACK_DX1 = 6, EPI_STACK_DX0 = 7 };

// The parts of a stack's elementwise prologue: the layer-0 input xtot, the
// layer-1 input x1 and, in the note stack, the heads.
enum { PRO_XTOT = 1, PRO_X1 = 2, PRO_HEADS = 4 };

template <typename T>
struct EpiArgs {
  T* out_t;        // PRE, XW: z [M][N]; IN: P [M][N]; DX0, STACK_DX0: dx
                   // [M][N]; STACK_DX1: ds1m [M][N]; NOTE_DX: dht
  const T* bias;   // PRE, IN: [N]
  float* out_a;    // DX1: style-1 rows; DX0, NOTE_DX: style-0 rows
  float* out_b;    // DX1, STACK_DX1: the mid term added to layer 0's dh
  PassDims d;
  Drop drop;
  T* out_c;        // NOTE_DX: dch [M][N - split]
  int split;       // NOTE_DX: the Ht columns of the time stack's output
  const T* xw;     // XW: the input projection [M][N]
};

// PRE: z = ((A1 B1 -> T) + b) + (A2 B2 -> T), the cast order of `_cell_fwd`;
// `pre_first` forms the first term, exact in T, after the first product.
// IN: P = (A B -> T) + b, that first term alone.
// XW: z = xw + (A B -> T), the cast order of the recurrence's `_cell`.
// DX1: dx1 = A B in float32; style-1 rows dx1 m_style1, mid term dx1 m_mid.
// DX0: dx = A B rounded to T; style-0 rows (float32 product) dx m_style0.
// NOTE_DX: the note stack's dx = [dxt | dch] (D = Ht + C columns): dht =
// dxt m_in rounded to T, scattered into [T, N, B, Ht] (A, S, B, Ht);
// dch = dch rounded to T, no mask, [M][C]; style-0 rows dxt m_style0 over
// the Ht columns (width Ht) and dch m_style0c over the C columns (width C,
// column n - Ht).
// The fused two-layer stack's (lstm2.cu; PassDims {S, 1, R, H, 1}, so row
// g of a step is tile 0, row g): STACK_DX1: ds1m = dx1 rounded to T, mid
// term dx1 m_stack_mid in float32; STACK_DX0: dx = A B rounded to T alone.
template <typename T>
__device__ __forceinline__ float pre_first(const EpiArgs<T>& e, int n,
                                           float v) {
  return add_t<T>(rnd<T>(v), ld(e.bias + n));
}

template <typename T, int MODE>
__device__ __forceinline__ void epilogue(const EpiArgs<T>& e, int N, int m,
                                         int n, float v1, float v2) {
  const size_t o = (size_t)m * N + n;
  if constexpr (MODE == EPI_PRE) {
    st(e.out_t + o, add_t<T>(v1, rnd<T>(v2)));
  } else if constexpr (MODE == EPI_IN) {
    st(e.out_t + o, pre_first(e, n, v1));
  } else if constexpr (MODE == EPI_XW) {
    st(e.out_t + o, add_t<T>(ld(e.xw + o), rnd<T>(v1)));
  } else if constexpr (MODE == EPI_STACK_DX0) {
    st(e.out_t + o, v1);
  } else if constexpr (MODE == EPI_STACK_DX1) {
    st(e.out_t + o, v1);
    float mb = 1.f;
    if (e.drop.on) {
      const int R = e.d.A * e.d.B, s = m / R;
      const RowPos p = row_pos(m % R, e.d.B, e.d.k);
      mb = mval(e.drop, S_STACK_MID, p.j, s, p.r, N, n);
    }
    e.out_b[o] = e.drop.on ? __fmul_rn(v1, mb) : v1;
  } else if constexpr (MODE == EPI_NOTE_DX) {
    const int R = e.d.A * e.d.B, s = m / R, Ht = e.split;
    const RowPos p = row_pos(m % R, e.d.B, e.d.k);
    float m0 = 1.f;
    if (n < Ht) {
      float mi = 1.f;
      if (e.drop.on) {
        mi = mval(e.drop, S_IN, p.j, s, p.r, Ht, n);
        m0 = mval(e.drop, S_STYLE0, p.j, s, p.r, Ht, n);
      }
      st(e.out_t + (((size_t)p.a * e.d.S + s) * e.d.B + p.b) * Ht + n,
         e.drop.on ? __fmul_rn(v1, mi) : v1);
    } else {
      const int C = N - Ht, c = n - Ht;
      if (e.drop.on) m0 = mval(e.drop, S_STYLE0C, p.j, s, p.r, C, c);
      st(e.out_c + (size_t)m * C + c, v1);
    }
    e.out_a[o] = e.drop.on ? __fmul_rn(v1, m0) : v1;
  } else {
    float ma = 1.f, mb = 1.f;
    if (e.drop.on) {
      const int R = e.d.A * e.d.B, s = m / R;
      const RowPos p = row_pos(m % R, e.d.B, e.d.k);
      ma = mval(e.drop, MODE == EPI_DX1 ? S_STYLE1 : S_STYLE0, p.j, s, p.r,
                N, n);
      if (MODE == EPI_DX1) mb = mval(e.drop, S_MID, p.j, s, p.r, N, n);
    }
    e.out_a[o] = e.drop.on ? __fmul_rn(v1, ma) : v1;
    if constexpr (MODE == EPI_DX1)
      e.out_b[o] = e.drop.on ? __fmul_rn(v1, mb) : v1;
    else
      st(e.out_t + o, v1);
  }
}

// Columns n and n + 1 of row m (n even, N even) with paired stores.
template <int MODE>
__device__ __forceinline__ void epilogue_pair(const EpiArgs<bf16>& e, int N,
                                              int m, int n, float a0,
                                              float a1, float b0, float b1) {
  const size_t o = (size_t)m * N + n;
  if constexpr (MODE == EPI_PRE) {
    *reinterpret_cast<uint32_t*>(e.out_t + o) =
        pack_bf16(add_t<bf16>(a0, rnd<bf16>(b0)),
                  add_t<bf16>(a1, rnd<bf16>(b1)));
  } else if constexpr (MODE == EPI_IN) {
    *reinterpret_cast<uint32_t*>(e.out_t + o) =
        pack_bf16(pre_first(e, n, a0), pre_first(e, n + 1, a1));
  } else if constexpr (MODE == EPI_XW) {
    *reinterpret_cast<uint32_t*>(e.out_t + o) =
        pack_bf16(add_t<bf16>(ld(e.xw + o), rnd<bf16>(a0)),
                  add_t<bf16>(ld(e.xw + o + 1), rnd<bf16>(a1)));
  } else if constexpr (MODE == EPI_STACK_DX0) {
    *reinterpret_cast<uint32_t*>(e.out_t + o) = pack_bf16(a0, a1);
  } else if constexpr (MODE == EPI_STACK_DX1) {
    float2 vb = make_float2(a0, a1);
    if (e.drop.on) {
      const int R = e.d.A * e.d.B, s = m / R;
      const RowPos p = row_pos(m % R, e.d.B, e.d.k);
      vb.x = __fmul_rn(a0, mval(e.drop, S_STACK_MID, p.j, s, p.r, N, n));
      vb.y = __fmul_rn(a1, mval(e.drop, S_STACK_MID, p.j, s, p.r, N, n + 1));
    }
    *reinterpret_cast<uint32_t*>(e.out_t + o) = pack_bf16(a0, a1);
    *reinterpret_cast<float2*>(e.out_b + o) = vb;
  } else {
    float2 va = make_float2(a0, a1), vb = va;
    if (e.drop.on) {
      const int R = e.d.A * e.d.B, s = m / R;
      const RowPos p = row_pos(m % R, e.d.B, e.d.k);
      const int site = MODE == EPI_DX1 ? S_STYLE1 : S_STYLE0;
      va.x = __fmul_rn(a0, mval(e.drop, site, p.j, s, p.r, N, n));
      va.y = __fmul_rn(a1, mval(e.drop, site, p.j, s, p.r, N, n + 1));
      if (MODE == EPI_DX1) {
        vb.x = __fmul_rn(a0, mval(e.drop, S_MID, p.j, s, p.r, N, n));
        vb.y = __fmul_rn(a1, mval(e.drop, S_MID, p.j, s, p.r, N, n + 1));
      }
    }
    *reinterpret_cast<float2*>(e.out_a + o) = va;
    if constexpr (MODE == EPI_DX1)
      *reinterpret_cast<float2*>(e.out_b + o) = vb;
    else
      *reinterpret_cast<uint32_t*>(e.out_t + o) = pack_bf16(a0, a1);
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// bfloat16: 128 x 64 output tiles over 8 warps of 32 x 32 (4 along M, 2
// along N), mma.sync m16n8k16 with float32 accumulation; 32-wide K tiles
// in a 3-stage cp.async ring (rows of 40 values: 16-byte aligned, and
// ldmatrix's eight rows fall on distinct banks).  The grid walks N
// fastest, so the blocks that share a panel of A run together and find it
// in L2: A (the largest operand) comes from device memory once.
constexpr int GBM = 128, GBN = 64, GBK = 32, GLD = GBK + 8, GST = 3;
constexpr int GTHREADS = 256;

__device__ __forceinline__ void gemm_load(const Operand<bf16>& op, int M,
                                          int N, int m0, int n0, int k0,
                                          bf16* As, bf16* Bs) {
  const bool vec = (op.lda & 7) == 0;
  for (int e = threadIdx.x; e < GBM * 4; e += GTHREADS) {
    const int rr = e >> 2, c8 = (e & 3) * 8, row = m0 + rr;
    const int ar = row - op.shift, kk = k0 + c8;
    const bool in = row < M && ar >= 0;
    bf16* dst = As + rr * GLD + c8;
    if (vec) {
      const bool ok = in && kk < op.K;
      cp_async16(dst, ok ? (const void*)(op.A + (size_t)ar * op.lda + kk)
                         : (const void*)op.A, ok);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        dst[q] = (in && kk + q < op.K) ? op.A[(size_t)ar * op.lda + kk + q]
                                       : __float2bfloat16(0.f);
    }
  }
  for (int e = threadIdx.x; e < GBN * 4; e += GTHREADS) {
    const int rr = e >> 2, c8 = (e & 3) * 8, n = n0 + rr, kk = k0 + c8;
    const bool ok = n < N && kk < op.ldb;
    cp_async16(Bs + rr * GLD + c8,
               ok ? (const void*)(op.B + (size_t)n * op.ldb + kk)
                  : (const void*)op.B, ok);
  }
}

// acc[i][j]: the warp's m16 tile i and n8 tile j.  Ends with a barrier, so
// a second product may reuse the ring.
__device__ __forceinline__ void gemm_mainloop(const Operand<bf16>& op,
                                              int M, int N, int m0, int n0,
                                              bf16* As, bf16* Bs,
                                              float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  const int KT = (op.K + GBK - 1) / GBK;
  for (int s = 0; s < GST - 1; ++s) {
    if (s < KT)
      gemm_load(op, M, N, m0, n0, s * GBK, As + s * GBM * GLD,
                Bs + s * GBN * GLD);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<GST - 2>();
    __syncthreads();
    const int nxt = kt + GST - 1;
    if (nxt < KT)
      gemm_load(op, M, N, m0, n0, nxt * GBK, As + (nxt % GST) * GBM * GLD,
                Bs + (nxt % GST) * GBN * GLD);
    cp_async_commit();
    const bf16* as = As + (kt % GST) * GBM * GLD;
    const bf16* bs = Bs + (kt % GST) * GBN * GLD;
#pragma unroll
    for (int ks = 0; ks < GBK; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], as + (wm + i * 16 + (lane & 15)) * GLD + ks +
                           (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t v[4];
        ldsm_x4(v, bs + (wn + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * GLD +
                       ks + ((lane >> 3) & 1) * 8);
        bfr[j][0] = v[0];
        bfr[j][1] = v[1];
        bfr[j + 1][0] = v[2];
        bfr[j + 1][1] = v[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                   bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(GTHREADS) gemm_mma_kernel(
    Operand<bf16> p1, Operand<bf16> p2, int M, int N, EpiArgs<bf16> e) {
  __shared__ __align__(16) bf16 As[GST * GBM * GLD];
  __shared__ __align__(16) bf16 Bs[GST * GBN * GLD];
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4];
  uint32_t first[2][4][2];   // PRE: the first term, exact in bf16, packed
  gemm_mainloop(p1, M, N, m0, n0, As, Bs, acc);
  if constexpr (MODE == EPI_PRE) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + j * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          first[i][j][h] = pack_bf16(
              n < N ? pre_first(e, n, acc[i][j][2 * h]) : 0.f,
              n + 1 < N ? pre_first(e, n + 1, acc[i][j][2 * h + 1]) : 0.f);
    }
    gemm_mainloop(p2, M, N, m0, n0, As, Bs, acc);
  }
  // The note's dx writes its columns to two tensors: one at a time.
  const bool paired = MODE != EPI_NOTE_DX && (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + 8 * h;
        const int n = n0 + wn + j * 8 + 2 * t;
        if (m >= M || n >= N) continue;
        float a0 = acc[i][j][2 * h], a1 = acc[i][j][2 * h + 1];
        const float b0 = a0, b1 = a1;
        if constexpr (MODE == EPI_PRE) {
          const float2 f = unpack_bf16(first[i][j][h]);
          a0 = f.x;
          a1 = f.y;
        }
        if (paired) {
          epilogue_pair<MODE>(e, N, m, n, a0, a1, b0, b1);
        } else {
          epilogue<bf16, MODE>(e, N, m, n, a0, b0);
          if (n + 1 < N) epilogue<bf16, MODE>(e, N, m, n + 1, a1, b1);
        }
      }
}

// float32: 64 x 64 tiles on the CUDA cores, 256 threads of 4 x 4 outputs.
__device__ __forceinline__ void fma_mainloop(const Operand<float>& op,
                                             int M, int N, int m0, int n0,
                                             float (*As)[65],
                                             float (*Bs)[64],
                                             float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < op.K; k0 += 16) {
    for (int e = threadIdx.x; e < 16 * 64; e += 256) {
      const int rr = e >> 4, kk = e & 15, row = m0 + rr;
      const int ar = row - op.shift, k = k0 + kk;
      As[kk][rr] = (row < M && ar >= 0 && k < op.K)
                       ? op.A[(size_t)ar * op.lda + k] : 0.f;
      const int bk = e >> 6, bn = e & 63;
      Bs[bk][bn] = (k0 + bk < op.K && n0 + bn < N)
                       ? op.B[(size_t)(k0 + bk) * op.ldb + n0 + bn] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < 16; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int MODE>
__global__ void __launch_bounds__(256) gemm_fma_kernel(
    Operand<float> p1, Operand<float> p2, int M, int N,
    EpiArgs<float> e) {
  __shared__ float As[16][65];
  __shared__ float Bs[16][64];
  const int n0 = blockIdx.x * 64, m0 = blockIdx.y * 64;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4], first[4][4];
  fma_mainloop(p1, M, N, m0, n0, As, Bs, acc);
  if constexpr (MODE == EPI_PRE) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        first[i][j] = n < N ? pre_first(e, n, acc[i][j]) : 0.f;
      }
    fma_mainloop(p2, M, N, m0, n0, As, Bs, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx + 16 * j;
      if (m < M && n < N)
        epilogue<float, MODE>(e, N, m, n,
                              MODE == EPI_PRE ? first[i][j] : acc[i][j],
                              acc[i][j]);
    }
}

// 3., 5. One layer's scan, reversed over s.  z_dz [M][4H] holds the
// layer's pre-activations on entry and its dz tape on exit (each thread
// reads a z element before it writes the dz of the same element).  The
// step's dh adds ext_t (T) or ext_f (float32) to the carried dz U^T: the
// time stack's layer 1 takes the cotangent of hs1, the note stack's the
// heads' gradient, and layer 0 of both the mid term.
//
// The ends of the scan, all null for the biaxial stacks (dc starts at zero,
// no product at s = 0, the final carries dropped); the single-layer
// recurrence's backward (lstm_recurrence.cu) sets all three.
struct ScanEnds {
  const float* dcT;   // [R][H]: the dc carry's seed, the cotangent of c_T
  float* dh0;         // [R][H]: dh after s = 0, dz_0 U^T
  float* dc0;         // [R][H]: the dc carry after s = 0
};

// The ends of a forward scan (fwd_scan_*), all null for the biaxial stacks
// (h[-1] = 0 with no product at s = 0, c starts at zero, the final carries
// dropped); the single-layer recurrence's forward (lstm_recurrence.cu) and
// the fused two-layer stack's (lstm2.cu) set all four.
struct FwdEnds {
  const float* h0;    // [R][H]: h[-1], rounded to T when read; the product
                      // then runs at s = 0 too
  const float* c0;    // [R][H]: the c carry's seed
  float* hT;          // [R][H]: h after s = S - 1, not rounded to T
  float* cT;          // [R][H]: the c carry after s = S - 1
};

// The cell backward of one unit from its gate pre-activations zz[0..3]
// and previous c: dz (rounded to T) into dz[0..3]; returns the carried dc.
template <typename T>
__device__ __forceinline__ float cell_step(const float* zz, float cp,
                                           float dh, float dc, int hard,
                                           float* dz) {
  const Gates q = gates<T>(zz, 1, 0, hard);
  return cell_bwd<T>(q, cp, tanh_c<T>(q, cp), dh, dc, hard, dz, 1, 0);
}

// Stage 1, streamed (the float32 route; chip_smoke.py also times it in
// bfloat16 beside stage 2): a block owns RB rows; dh = dz U^T streams U^T
// (`_layout(U^T)`) from L2 at every step.
template <typename T, int RB>
__global__ void __launch_bounds__(1024) scan_streamed_kernel(
    T* z_dz, const T* __restrict__ cs, const T* __restrict__ ext_t,
    const float* __restrict__ ext_f, const T* __restrict__ ut, PassDims d,
    int hard, ScanEnds ends) {
  extern __shared__ float sm[];
  const int H = d.H, H4 = 4 * H, R = d.A * d.B, l4 = padk(H4);
  float* dz = sm;                 // [RB][l4], rows past R stay zero
  float* dh = dz + RB * l4;
  float* dc = dh + RB * H;
  float* scr = dc + RB * H;
  const int tid = threadIdx.x, nt = blockDim.x, g0 = blockIdx.x * RB;
  for (int i = tid; i < RB * (l4 + 2 * H); i += nt) sm[i] = 0.f;
  __syncthreads();
  // dc[i] is read and written by thread i % nt alone, the cells' item.
  if (ends.dcT)
    for (int i = tid; i < RB * H; i += nt)
      if (g0 + i / H < R) dc[i] = ends.dcT[(size_t)(g0 + i / H) * H + i % H];
  for (int t = d.S - 1; t >= 0; --t) {
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      if (g >= R) continue;
      const size_t m = (size_t)t * R + g;
      T* zr = z_dz + m * H4;
      float zz[4], v[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) zz[a] = ld(zr + a * H + j);
      const float ext = ext_t ? ld(ext_t + m * H + j) : ext_f[m * H + j];
      dc[i] = cell_step<T>(zz, ld(cs + m * H + j), dh[i] + ext, dc[i], hard,
                           v);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        dz[rr * l4 + a * H + j] = v[a];
        st(zr + a * H + j, v[a]);
      }
    }
    __syncthreads();
    if (t > 0 || ends.dh0)
      matvec<T, RB>(dz, l4, H4, ut, H, scr,
                    [&](int rr, int c, float s) { dh[rr * H + c] = s; });
  }
  // matvec ended with a barrier, so dh is whole.
  for (int i = tid; i < RB * H; i += nt) {
    if (g0 + i / H >= R) continue;
    const size_t o = (size_t)(g0 + i / H) * H + i % H;
    if (ends.dh0) ends.dh0[o] = dh[i];
    if (ends.dc0) ends.dc0[o] = dc[i];
  }
}

// Stage 2, U resident in a thread-block cluster (bfloat16).  A cluster of
// C blocks owns RT rows (g0 ..) for the whole scan; block q of the cluster
// owns the UJ units j0 = q UJ .. and keeps U[j0 .., :] (UJ x 4H, 128 KB at
// most) in its shared memory, loaded once.  Each step: (a) each thread runs
// the cell backward of one row and two units and writes those dz columns
// into every block's dz tile through distributed shared memory; a cluster
// barrier; (b) 16 warps compute dh[:, the block's units] = dz U[units, :]^T
// from shared memory alone (mma.sync, units on the M side, rows on the N
// side, K split over warps and summed in a fixed order); a second barrier
// before the next step overwrites the dz tiles.  Clusters never talk to
// each other; RT is chosen so that all clusters are resident at once (two
// waves would double the chain).  Both shared tiles are [rows][Kp] bfloat16
// (Kp = 4H rounded up to 64) with 16-byte chunk c of row r stored at
// c ^ (r & 7), so ldmatrix's eight rows hit distinct banks.  At H <= 128
// one layer's U fits one block (C = 1): the cluster is that block.
struct ClusterPlan { int C, UJ, UJp, Kp, RT, RTp, NT, parts, active; };

__device__ __forceinline__ int swz(int r, int k, int Kp) {
  return r * Kp + ((((k >> 3) ^ (r & 7))) << 3) + (k & 7);
}

// 1024 threads run the cell backward (its tanh chains need many warps in
// flight); at most CL_PROD_WARPS of them split the product's K.
constexpr int CL_THREADS = 1024, CL_PROD_WARPS = 16, CL_NTMAX = 4,
              CL_SMEM_MAX = 232448, CL_U_BYTES = 131072;

template <int NT>
__global__ void __launch_bounds__(CL_THREADS, 1) scan_cluster_kernel(
    bf16* z_dz, const bf16* __restrict__ cs, const bf16* __restrict__ ext_t,
    const float* __restrict__ ext_f, const bf16* __restrict__ u, PassDims d,
    ClusterPlan P, int hard, unsigned long long* prof, ScanEnds ends) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smraw[];
  const int H = d.H, H4 = 4 * H, R = d.A * d.B, Kp = P.Kp, UJ = P.UJ;
  const int RT = P.RT;
  bf16* Us = reinterpret_cast<bf16*>(smraw);              // [UJp][Kp]
  bf16* dzs = Us + (size_t)P.UJp * Kp;                     // [RTp][Kp]
  float* dhp = reinterpret_cast<float*>(dzs + (size_t)P.RTp * Kp);
  float* scr = dhp + RT * UJ;                  // [parts][RT][UJ]
  const int q = (int)cluster.block_rank(), C = P.C;
  const int j0 = q * UJ, g0 = (blockIdx.x / C) * RT;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < P.UJp * Kp; i += nt) {
    const int jj = i / Kp, c = i % Kp, j = j0 + jj;
    Us[swz(jj, c, Kp)] =
        (jj < UJ && j < H && c < H4) ? u[(size_t)j * H4 + c] : zero;
  }
  for (int i = tid; i < P.RTp * Kp; i += nt) dzs[i] = zero;
  for (int i = tid; i < RT * UJ; i += nt) dhp[i] = 0.f;
  // The thread's item of (a): row rr, units jp, jp + 1 (RT ceil(UJ / 2)
  // <= blockDim).  Paired columns go to the peers as one 4-byte store when
  // H and UJ are even.
  const int UJ2 = (UJ + 1) / 2, rr = tid / UJ2, jp = (tid % UJ2) * 2;
  bool ok[2];
#pragma unroll
  for (int w = 0; w < 2; ++w)
    ok[w] = rr < RT && g0 + rr < R && jp + w < UJ && j0 + jp + w < H;
  const bool pairs = (H % 2 == 0) && (UJ % 2 == 0);
  const size_t own = (size_t)(g0 + rr) * H + j0 + jp;   // [R][H] offset
  float dc[2] = {0.f, 0.f};
  if (ends.dcT)
#pragma unroll
    for (int w = 0; w < 2; ++w)
      if (ok[w]) dc[w] = ends.dcT[own + w];
  cluster.sync();
  const int lane = tid & 31, warp = tid >> 5;
  const uint32_t sa_us = (uint32_t)__cvta_generic_to_shared(Us);
  const uint32_t sa_dz = (uint32_t)__cvta_generic_to_shared(dzs);
  const int MT = P.UJp / 16, KS = Kp / 16, parts = P.parts;
  const int per = (KS + parts - 1) / parts;
  // prof (block 0, thread 0): clock cycles summed over the steps of its
  // own cell work, the rest of (a) with the first barrier, (b), and the
  // second barrier; then the plan.
  const bool rec = prof != nullptr && blockIdx.x == 0 && tid == 0;
  unsigned long long ck[4] = {0, 0, 0, 0}, c0 = 0, c1 = 0;
  for (int t = d.S - 1; t >= 0; --t) {
    if (rec) c0 = clock64();
    // (a) the cell backward of this block's units; dz to every block.
    if (ok[0]) {
      const size_t m = (size_t)t * R + g0 + rr;
      bf16* zr = z_dz + m * H4;
      float zz[2][4], cp[2], ext[2], v[2][4];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (!ok[w]) continue;
        const int j = j0 + jp + w;
#pragma unroll
        for (int a = 0; a < 4; ++a) zz[w][a] = ld(zr + a * H + j);
        cp[w] = ld(cs + m * H + j);
        ext[w] = ext_t ? ld(ext_t + m * H + j) : ext_f[m * H + j];
      }
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (!ok[w]) continue;
        dc[w] = cell_step<bf16>(zz[w], cp[w], dhp[rr * UJ + jp + w] + ext[w],
                                dc[w], hard, v[w]);
#pragma unroll
        for (int a = 0; a < 4; ++a) st(zr + a * H + j0 + jp + w, v[w][a]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int c = a * H + j0 + jp;
        if (pairs && ok[1]) {
          const int off = swz(rr, c, Kp);
          const uint32_t pv = pack_bf16(v[0][a], v[1][a]);
          for (int r = 0; r < C; ++r)
            *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(dzs, r) +
                                         off) = pv;
        } else {
          for (int w = 0; w < 2; ++w) {
            if (!ok[w]) continue;
            const int off = swz(rr, c + w, Kp);
            for (int r = 0; r < C; ++r)
              cluster.map_shared_rank(dzs, r)[off] =
                  __float2bfloat16(v[w][a]);
          }
        }
      }
    }
    if (rec) {
      c1 = clock64();
      ck[0] += c1 - c0;
    }
    cluster.sync();
    if (rec) {
      c0 = clock64();
      ck[1] += c0 - c1;
    }
    // (b) dh[:, units] = dz U[units, :]^T: warp (mt, p) multiplies m16
    // tile mt of the units by all rows over K part p.
    if (t > 0 || ends.dh0) {
      if (warp < MT * parts) {
        const int mt = warp % MT, p = warp / MT;
        const int ks0 = p * per, ks1 = min(KS, ks0 + per);
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        // Lane addresses: row bases in shared space; chunk c of a row
        // lies at (c ^ (row & 7)) 16 bytes.
        const int ra = mt * 16 + (lane & 15);
        const int rb = (lane & 7) + ((lane >> 4) << 3);
        const uint32_t abase = sa_us + (uint32_t)ra * Kp * 2;
        const uint32_t bbase = sa_dz + (uint32_t)rb * Kp * 2;
        const int ahi = lane >> 4, bhi = (lane >> 3) & 1;
        const int axr = ra & 7, bxr = rb & 7;
#pragma unroll 2
        for (int ks = ks0; ks < ks1; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, abase + ((uint32_t)((2 * ks + ahi) ^ axr) << 4));
          const uint32_t boff = (uint32_t)((2 * ks + bhi) ^ bxr) << 4;
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            // n8 tiles n and n + 1 (rows past 8 NT are zero).
            uint32_t b[4];
            ldsm_x4(b, bbase + (uint32_t)n * 8 * Kp * 2 + boff);
            mma_bf16(acc[n], a[0], a[1], a[2], a[3], b[0], b[1]);
            if (n + 1 < NT)
              mma_bf16(acc[n + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
          }
        }
        // acc[n][e]: unit mt 16 + g + 8 (e >> 1), row 8 n + 2 t4 + (e & 1).
        const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = mt * 16 + g + 8 * (e >> 1);
            const int r = n * 8 + 2 * t4 + (e & 1);
            if (jj < UJ && r < RT) {
              if (parts == 1)
                dhp[r * UJ + jj] = acc[n][e];
              else
                scr[(p * RT + r) * UJ + jj] = acc[n][e];
            }
          }
      }
      if (parts > 1) {
        __syncthreads();
        for (int i = tid; i < RT * UJ; i += nt) {
          float sum = 0.f;
          for (int p = 0; p < parts; ++p) sum += scr[p * RT * UJ + i];
          dhp[i] = sum;
        }
      }
    }
    if (rec) {
      c1 = clock64();
      ck[2] += c1 - c0;
    }
    cluster.sync();
    if (rec) ck[3] += clock64() - c1;
  }
  // After the last barrier dhp holds dz_0 U^T for the block's units.
  if (ends.dh0)
    for (int i = tid; i < RT * UJ; i += nt) {
      const int r = i / UJ, jj = i % UJ;
      if (g0 + r < R && j0 + jj < H)
        ends.dh0[(size_t)(g0 + r) * H + j0 + jj] = dhp[i];
    }
  if (ends.dc0)
#pragma unroll
    for (int w = 0; w < 2; ++w)
      if (ok[w]) ends.dc0[own + w] = dc[w];
  if (rec) {
    for (int i = 0; i < 4; ++i) prof[i] = ck[i];
    prof[4] = C;
    prof[5] = RT;
    prof[6] = UJ;
    prof[7] = parts;
    prof[8] = P.active;
  }
}

constexpr int SCAN_RB = 6;   // streamed scans: 128 blocks at the time stack

template <typename T, int MODE>
int gemm(const Operand<T>& p1, const Operand<T>& p2, int M, int N,
         const EpiArgs<T>& e, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
    gemm_mma_kernel<MODE><<<grid, GTHREADS, 0, st>>>(p1, p2, M, N, e);
  } else {
    const dim3 grid((N + 63) / 64, (M + 63) / 64);
    gemm_fma_kernel<MODE><<<grid, 256, 0, st>>>(p1, p2, M, N, e);
  }
  return (int)cudaGetLastError();
}

// The operand of a product with K-wide rows and an N-wide result: B's row
// stride in the layout of T.
template <typename T>
Operand<T> operand(const void* A, int lda, int shift, int K, const void* B,
                   int N) {
  const int ldb = std::is_same<T, bf16>::value ? padk(K) : N;
  return {(const T*)A, lda, shift, K, (const T*)B, ldb};
}

// 2. z [M][4H] = ((xin W -> T) + bias) + (hs[m - R] U -> T), hs rows
// before R read as zero: one layer's pre-activations over all M = S R rows.
// xin [M][ldx] with K columns; w, u in the layout of T.
inline int launch_preact(int bf16_, const void* xin, int ldx, int K,
                         const void* w, const void* bias, const void* hs,
                         const void* u, void* z, int M, int R, int H,
                         cudaStream_t st) {
  const int H4 = 4 * H;
  if (bf16_) {
    EpiArgs<bf16> e = {(bf16*)z, (const bf16*)bias};
    return gemm<bf16, EPI_PRE>(operand<bf16>(xin, ldx, 0, K, w, H4),
                               operand<bf16>(hs, H, R, H, u, H4), M, H4, e,
                               st);
  }
  EpiArgs<float> e = {(float*)z, (const float*)bias};
  return gemm<float, EPI_PRE>(operand<float>(xin, ldx, 0, K, w, H4),
                              operand<float>(hs, H, R, H, u, H4), M, H4, e,
                              st);
}

// 4., 6. The product dz [M][K] W^T (wt = `_layout(W^T)`, an Nout-wide
// result) with the epilogue MODE; out_c and split for EPI_NOTE_DX only.
template <int MODE>
int launch_dx(int bf16_, const void* dz, const void* wt, int M, int K,
              int Nout, void* out_t, float* out_a, float* out_b, void* out_c,
              int split, PassDims d, Drop drop, cudaStream_t st) {
  if (bf16_) {
    const auto op = operand<bf16>(dz, K, 0, K, wt, Nout);
    const EpiArgs<bf16> e = {(bf16*)out_t, nullptr, out_a, out_b, d, drop,
                             (bf16*)out_c, split};
    return gemm<bf16, MODE>(op, op, M, Nout, e, st);
  }
  const auto op = operand<float>(dz, K, 0, K, wt, Nout);
  const EpiArgs<float> e = {(float*)out_t, nullptr, out_a, out_b, d, drop,
                            (float*)out_c, split};
  return gemm<float, MODE>(op, op, M, Nout, e, st);
}

template <typename T>
int scan_streamed(void* z_dz, const void* cs, const void* ext_t,
                  const void* ext_f, const void* ut, PassDims d, int hard,
                  const ScanEnds& ends, cudaStream_t st) {
  const int R = d.A * d.B, H4 = 4 * d.H, RB = SCAN_RB;
  const int nt = threads_for(H4);
  const size_t smem = sizeof(float) * (RB * (padk(H4) + 2 * d.H) + nt * RB);
  auto kern = scan_streamed_kernel<T, SCAN_RB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<(R + RB - 1) / RB, nt, smem, st>>>(
      (T*)z_dz, (const T*)cs, (const T*)ext_t, (const float*)ext_f,
      (const T*)ut, d, hard, ends);
  return (int)cudaGetLastError();
}

inline size_t cluster_smem(const ClusterPlan& p) {
  return sizeof(bf16) * (size_t)(p.UJp + p.RTp) * p.Kp +
         sizeof(float) * (size_t)(1 + p.parts) * p.RT * p.UJ;
}

// C: the least power of two whose share of U (UJ rows, padded to 16, of
// Kp values) fits CL_U_BYTES.  RT: the rows of a cluster, ceil(R / the
// clusters that fit on the card at once, per
// cudaOccupancyMaxActiveClusters), so that the launch is one wave, within
// what shared memory and one item per thread allow.  A refused launch
// returns its error.
inline int scan_cluster(void* z_dz, const void* cs, const void* ext_t,
                        const void* ext_f, const void* u, PassDims d,
                        int hard, unsigned long long* prof,
                        const ScanEnds& ends, cudaStream_t st) {
  const int R = d.A * d.B;
  ClusterPlan p;
  p.Kp = (4 * d.H + 63) & ~63;
  for (p.C = 1;; p.C *= 2) {
    p.UJ = (d.H + p.C - 1) / p.C;
    p.UJp = (p.UJ + 15) & ~15;
    if ((size_t)p.UJp * p.Kp * sizeof(bf16) <= CL_U_BYTES || p.C >= 16) break;
  }
  if ((size_t)p.UJp * p.Kp * sizeof(bf16) > CL_U_BYTES)
    return (int)cudaErrorInvalidValue;
  p.parts = std::max(1, std::min(p.Kp / 16, CL_PROD_WARPS / (p.UJp / 16)));
  auto fits = [&](int rt) {
    p.RT = rt;
    p.NT = (rt + 7) / 8;
    p.RTp = 16 * ((rt + 15) / 16);   // whole pairs of n8 tiles
    return cluster_smem(p) <= CL_SMEM_MAX &&
           rt * ((p.UJ + 1) / 2) <= CL_THREADS;
  };
  int rt_max = 8 * CL_NTMAX;
  while (rt_max > 0 && !fits(rt_max)) --rt_max;
  if (rt_max == 0) return (int)cudaErrorInvalidConfiguration;
  // One instantiation per count of n8 row tiles (CL_NTMAX = 4).
  void (*const kerns[])(bf16*, const bf16*, const bf16*, const float*,
                        const bf16*, PassDims, ClusterPlan, int,
                        unsigned long long*, ScanEnds) = {
      scan_cluster_kernel<1>, scan_cluster_kernel<2>, scan_cluster_kernel<3>,
      scan_cluster_kernel<4>};
  cudaError_t err;
  for (auto kern : kerns) {
    if (p.C > 8 && (err = cudaFuncSetAttribute(
                        kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                        1)) != cudaSuccess)
      return (int)err;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             CL_SMEM_MAX)) != cudaSuccess)
      return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(CL_THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  fits(rt_max);
  cfg.gridDim = dim3(p.C * ((R + rt_max - 1) / rt_max));
  cfg.dynamicSmemBytes = cluster_smem(p);
  if ((err = cudaOccupancyMaxActiveClusters(&p.active, kerns[p.NT - 1],
                                             &cfg)) != cudaSuccess)
    return (int)err;
  if (p.active == 0) return (int)cudaErrorInvalidConfiguration;
  fits(std::min(rt_max, (R + p.active - 1) / p.active));
  cfg.gridDim = dim3(p.C * ((R + p.RT - 1) / p.RT));
  cfg.dynamicSmemBytes = cluster_smem(p);
  err = cudaLaunchKernelEx(&cfg, kerns[p.NT - 1], (bf16*)z_dz, (const bf16*)cs,
                           (const bf16*)ext_t, (const float*)ext_f,
                           (const bf16*)u, d, p, hard, prof, ends);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// 3., 5. One layer's reversed scan over z_dz (z in, dz out); the step's dh
// adds ext_t (T) or ext_f (float32).  cluster = 1 (bfloat16 only): U
// [H][4H] resident in a thread-block cluster; cluster = 0: u is
// `_layout(U^T)`, streamed.  prof (cluster scan only, may be null): four
// clock-cycle sums of the first block's steps and its plan, see
// scan_cluster_kernel.  ends: see ScanEnds (the stacks pass none).
inline int launch_scan(int bf16_, int cluster, void* z_dz, const void* cs,
                       const void* ext_t, const void* ext_f, const void* u,
                       PassDims d, int hard, unsigned long long* prof,
                       cudaStream_t st, const ScanEnds& ends = ScanEnds{}) {
  if (cluster) {
    if (!bf16_) return (int)cudaErrorInvalidValue;
    return scan_cluster(z_dz, cs, ext_t, ext_f, u, d, hard, prof, ends, st);
  }
  if (bf16_)
    return scan_streamed<bf16>(z_dz, cs, ext_t, ext_f, u, d, hard, ends, st);
  return scan_streamed<float>(z_dz, cs, ext_t, ext_f, u, d, hard, ends, st);
}

// ---------------------------------------------------------------------------
// The forward of one layer (both forwards' passes 3 and 6, and the
// single-layer recurrence's forward), forward over s: z = add_t(P[s],
// rnd_T(h[s-1] U)), the gates in T, c carried in float32, h = o tanh(c ->
// T) rounded to T.  P [M][4H] holds the layer's input pre-activations
// (EPI_IN; the recurrence's xw); the scan writes hs [M][H] and, when cs is
// not null, cs [M][H] (the previous c, in T).  u is `_layout(U)` in both
// routes.  With null ends h[-1] = 0 and the product is skipped at s = 0;
// see FwdEnds.
// ---------------------------------------------------------------------------

// The unrounded h and the c carry after the last step into the ends.
__device__ __forceinline__ void fwd_terminal(const FwdEnds& ends, size_t o,
                                             float hT, float cT) {
  if (ends.hT) ends.hT[o] = hT;
  if (ends.cT) ends.cT[o] = cT;
}

// Streamed (the float32 route; chip_smoke.py also times it in bfloat16
// beside the cluster scan): a block owns RB rows; h U streams U from L2 at
// every step (`matvec`).
template <typename T, int RB>
__global__ void __launch_bounds__(1024) fwd_scan_streamed_kernel(
    const T* __restrict__ pre, T* __restrict__ hs, T* __restrict__ cs,
    const T* __restrict__ u, PassDims d, int hard, FwdEnds ends) {
  extern __shared__ float sm[];
  const int H = d.H, H4 = 4 * H, R = d.A * d.B, lH = padk(H);
  float* h = sm;                  // [RB][lH], zero past H and past R
  float* z = h + RB * lH;         // [RB][4H]: rnd_T(h U)
  float* c = z + RB * H4;         // [RB][H]
  float* scr = c + RB * H;
  const int tid = threadIdx.x, nt = blockDim.x, g0 = blockIdx.x * RB;
  for (int i = tid; i < RB * (lH + H4 + H); i += nt) sm[i] = 0.f;
  __syncthreads();
  // c[i] is read and written by thread i % nt alone, the cells' item.
  if (ends.h0 || ends.c0) {
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      if (g >= R) continue;
      if (ends.h0) h[rr * lH + j] = rnd<T>(ends.h0[(size_t)g * H + j]);
      if (ends.c0) c[i] = ends.c0[(size_t)g * H + j];
    }
    __syncthreads();
  }
  for (int s = 0; s < d.S; ++s) {
    const bool prod = s > 0 || ends.h0;
    if (prod)
      matvec<T, RB>(h, lH, H, u, H4, scr, [&](int rr, int col, float v) {
        z[rr * H4 + col] = rnd<T>(v);
      });
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      if (g >= R) continue;
      const size_t m = (size_t)s * R + g;
      float zz[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        zz[a] = ld(pre + m * H4 + a * H + j);
        if (prod) zz[a] = add_t<T>(zz[a], z[rr * H4 + a * H + j]);
      }
      const float cp = c[i];
      const Gates q = gates<T>(zz, 1, 0, hard);
      float hn;
      c[i] = cell<T>(q, cp, &hn);
      h[rr * lH + j] = hn;
      st(hs + m * H + j, hn);
      if (cs) st(cs + m * H + j, cp);
      if (s == d.S - 1)
        fwd_terminal(ends, (size_t)g * H + j,
                     __fmul_rn(q.o, tanh_t<T>(rnd<T>(c[i]))), c[i]);
    }
    __syncthreads();
  }
}

// U resident in a thread-block cluster (bfloat16), the plan of
// scan_cluster.  A cluster of C blocks owns RT rows (g0 ..) for the whole
// scan; block q owns the UJ units j0 = q UJ .. and keeps the 4 UJ columns
// of U that feed their gates, {a H + j}, as a [4 UJ][H] tile (gate row
// r = a UJ + jj; the A side of mma.sync, K = H), loaded once.  Each step:
// (a) warp w multiplies m16 tile w of the gate rows by the h tile of every
// row of the cluster over all of K (no K parts), into float32 gate sums in
// shared memory; a block barrier; (b) each thread runs the cell of one row
// and two units, writes hs and cs to device memory, and writes h (bf16)
// into the next h tile of every block of the cluster through distributed
// shared memory; one cluster barrier.  The h tiles alternate by step: the
// products of step s read tile s % 2 while the cells write tile
// (s + 1) % 2, so no block can overwrite a tile a peer still reads, and
// one barrier a step suffices.  Both tiles are swizzled as the backward's
// (`swz`).  The P values of the step are loaded before the product, so
// their latency hides behind it.  The time stack (H = 256) takes C = 4;
// the note stack's H = 128 fits one block (C = 1, the [512][128] tile is
// 128 KB), whose "peers" are itself: h goes to its own next tile and the
// cluster barrier is a barrier of one block.  With ends.h0 each block
// writes h0 of all its cluster's rows into its own tile 0 before the first
// barrier (from device memory: no exchange), and step 0 runs the product.
// The ends are compiled in only when ENDS: the stacks' instantiation keeps
// the registers of its cells (64 a thread at 1024 threads) without them.
struct FwdPlan { int C, UJ, G4p, Kp, RT, RTp, NT, active; };

template <int NT, bool ENDS>
__global__ void __launch_bounds__(CL_THREADS, 1) fwd_scan_cluster_kernel(
    const bf16* __restrict__ pre, bf16* __restrict__ hs,
    bf16* __restrict__ cs, const bf16* __restrict__ u, PassDims d,
    FwdPlan P, int hard, unsigned long long* prof, FwdEnds ends) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smraw[];
  const int H = d.H, H4 = 4 * H, R = d.A * d.B, Kp = P.Kp, UJ = P.UJ;
  const int RT = P.RT, G4 = 4 * UJ, ZLD = G4 + 4, ldu = padk(H);
  bf16* Us = reinterpret_cast<bf16*>(smraw);              // [G4p][Kp]
  bf16* hb = Us + (size_t)P.G4p * Kp;                      // 2 x [RTp][Kp]
  // [RT][ZLD]: gate sums; the pad of 4 puts the 32 lanes of a store on
  // distinct banks.
  float* zs = reinterpret_cast<float*>(hb + 2 * (size_t)P.RTp * Kp);
  const int q = (int)cluster.block_rank(), C = P.C;
  const int j0 = q * UJ, g0 = (blockIdx.x / C) * RT;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < P.G4p * Kp; i += nt) {
    const int r = i / Kp, k = i % Kp, j = j0 + r % UJ;
    Us[swz(r, k, Kp)] = (r < G4 && j < H && k < H)
                            ? u[(size_t)((r / UJ) * H + j) * ldu + k]
                            : zero;
  }
  for (int i = tid; i < 2 * P.RTp * Kp; i += nt) hb[i] = zero;
  if (ENDS && ends.h0) {
    __syncthreads();
    for (int i = tid; i < RT * H; i += nt) {
      const int r = i / H, j = i % H;
      if (g0 + r < R)
        hb[swz(r, j, Kp)] =
            __float2bfloat16(ends.h0[(size_t)(g0 + r) * H + j]);
    }
  }
  // The thread's item of (b): row rr, units jp, jp + 1 (RT ceil(UJ / 2) <=
  // blockDim).  Paired columns move as one 4-byte load or store when H and
  // UJ are even.
  const int UJ2 = (UJ + 1) / 2, rr = tid / UJ2, jp = (tid % UJ2) * 2;
  bool ok[2];
#pragma unroll
  for (int w = 0; w < 2; ++w)
    ok[w] = rr < RT && g0 + rr < R && jp + w < UJ && j0 + jp + w < H;
  const bool pairs = (H % 2 == 0) && (UJ % 2 == 0);
  const size_t own = (size_t)(g0 + rr) * H + j0 + jp;   // [R][H] offset
  float c[2] = {0.f, 0.f};
  if (ENDS && ends.c0)
#pragma unroll
    for (int w = 0; w < 2; ++w)
      if (ok[w]) c[w] = ends.c0[own + w];
  cluster.sync();
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const uint32_t sa_us = (uint32_t)__cvta_generic_to_shared(Us);
  const uint32_t sa_h = (uint32_t)__cvta_generic_to_shared(hb);
  const int MT = P.G4p / 16, KS = Kp / 16;
  // prof (block 0, thread 0): clock cycles summed over the steps of the
  // product with the block barrier, its own cell work, and the cluster
  // barrier; then the plan.
  const bool rec = prof != nullptr && blockIdx.x == 0 && tid == 0;
  unsigned long long ck[3] = {0, 0, 0}, c0 = 0, c1 = 0;
  for (int s = 0; s < d.S; ++s) {
    if (rec) c0 = clock64();
    const bool prod = s > 0 || (ENDS && ends.h0);
    const size_t m = (size_t)s * R + g0 + rr;
    float pz[2][4];
    if (ok[0]) {
      const bf16* pr = pre + m * H4 + j0 + jp;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (pairs && ok[1]) {
          const float2 v = unpack_bf16(
              *reinterpret_cast<const uint32_t*>(pr + a * H));
          pz[0][a] = v.x;
          pz[1][a] = v.y;
        } else {
          pz[0][a] = ld(pr + a * H);
          pz[1][a] = ok[1] ? ld(pr + a * H + 1) : 0.f;
        }
      }
    }
    // (a) the gate sums h[s-1] U[:, the block's gate columns].
    if (prod) {
      const uint32_t hbase = sa_h + (uint32_t)((s & 1) * P.RTp * Kp) * 2;
      for (int mt = warp; mt < MT; mt += nwarps) {
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        const int ra = mt * 16 + (lane & 15);
        const int rb = (lane & 7) + ((lane >> 4) << 3);
        const uint32_t abase = sa_us + (uint32_t)ra * Kp * 2;
        const uint32_t bbase = hbase + (uint32_t)rb * Kp * 2;
        const int ahi = lane >> 4, bhi = (lane >> 3) & 1;
        const int axr = ra & 7, bxr = rb & 7;
#pragma unroll 4
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, abase + ((uint32_t)((2 * ks + ahi) ^ axr) << 4));
          const uint32_t boff = (uint32_t)((2 * ks + bhi) ^ bxr) << 4;
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t b[4];
            ldsm_x4(b, bbase + (uint32_t)n * 8 * Kp * 2 + boff);
            mma_bf16(acc[n], a[0], a[1], a[2], a[3], b[0], b[1]);
            if (n + 1 < NT)
              mma_bf16(acc[n + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
          }
        }
        // acc[n][e]: gate row mt 16 + g + 8 (e >> 1), cluster row
        // 8 n + 2 t4 + (e & 1).
        const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + g + 8 * (e >> 1);
            const int row = n * 8 + 2 * t4 + (e & 1);
            if (r < G4 && row < RT) zs[row * ZLD + r] = acc[n][e];
          }
      }
    }
    __syncthreads();
    if (rec) {
      c1 = clock64();
      ck[0] += c1 - c0;
    }
    // (b) the cell of this block's units; h to every block's next tile.
    if (ok[0]) {
      float hn[2] = {0.f, 0.f};
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (!ok[w]) continue;
        float zz[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          zz[a] = prod ? add_t<bf16>(pz[w][a], rnd<bf16>(
                             zs[rr * ZLD + a * UJ + jp + w]))
                       : pz[w][a];
        const float cp = c[w];
        const Gates q = gates<bf16>(zz, 1, 0, hard);
        c[w] = cell<bf16>(q, cp, &hn[w]);
        const size_t o = m * H + j0 + jp + w;
        st(hs + o, hn[w]);
        if (cs) st(cs + o, cp);
        if (ENDS && s == d.S - 1)
          fwd_terminal(ends, own + w,
                       __fmul_rn(q.o, tanh_t<bf16>(rnd<bf16>(c[w]))), c[w]);
      }
      bf16* nxt = hb + ((s + 1) & 1) * P.RTp * Kp;
      const int j = j0 + jp;
      if (pairs && ok[1]) {
        const int off = swz(rr, j, Kp);
        const uint32_t pv = pack_bf16(hn[0], hn[1]);
        for (int r = 0; r < C; ++r)
          *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(nxt, r) +
                                       off) = pv;
      } else {
        for (int w = 0; w < 2; ++w) {
          if (!ok[w]) continue;
          const int off = swz(rr, j + w, Kp);
          for (int r = 0; r < C; ++r)
            cluster.map_shared_rank(nxt, r)[off] = __float2bfloat16(hn[w]);
        }
      }
    }
    if (rec) {
      c0 = clock64();
      ck[1] += c0 - c1;
    }
    cluster.sync();
    if (rec) ck[2] += clock64() - c0;
  }
  if (rec) {
    for (int i = 0; i < 3; ++i) prof[i] = ck[i];
    prof[3] = 0;
    prof[4] = C;
    prof[5] = RT;
    prof[6] = UJ;
    prof[7] = 1;
    prof[8] = P.active;
  }
}

inline size_t fwd_cluster_smem(const FwdPlan& p) {
  return sizeof(bf16) * (size_t)(p.G4p + 2 * p.RTp) * p.Kp +
         sizeof(float) * (size_t)p.RT * (4 * p.UJ + 4);
}

// The plan of scan_cluster: C the least power of two whose [4 UJ][Kp] share
// of U fits CL_U_BYTES, RT = ceil(R / the clusters the card holds at once)
// within shared memory and one item per thread, so the launch is one wave.
// A refused launch returns its error.
inline int fwd_scan_cluster(const void* pre, void* hs, void* cs,
                            const void* u, PassDims d, int hard,
                            unsigned long long* prof, const FwdEnds& ends,
                            cudaStream_t st) {
  const int R = d.A * d.B;
  FwdPlan p;
  p.Kp = (d.H + 63) & ~63;
  for (p.C = 1;; p.C *= 2) {
    p.UJ = (d.H + p.C - 1) / p.C;
    p.G4p = (4 * p.UJ + 15) & ~15;
    if ((size_t)p.G4p * p.Kp * sizeof(bf16) <= CL_U_BYTES || p.C >= 16) break;
  }
  if ((size_t)p.G4p * p.Kp * sizeof(bf16) > CL_U_BYTES)
    return (int)cudaErrorInvalidValue;
  auto fits = [&](int rt) {
    p.RT = rt;
    p.NT = (rt + 7) / 8;
    p.RTp = 16 * ((rt + 15) / 16);   // whole pairs of n8 tiles
    return fwd_cluster_smem(p) <= CL_SMEM_MAX &&
           rt * ((p.UJ + 1) / 2) <= CL_THREADS;
  };
  int rt_max = 8 * CL_NTMAX;
  while (rt_max > 0 && !fits(rt_max)) --rt_max;
  if (rt_max == 0) return (int)cudaErrorInvalidConfiguration;
  // One instantiation per count of n8 row tiles (CL_NTMAX = 4), without and
  // with the ends.
  using Kern = void (*)(const bf16*, bf16*, bf16*, const bf16*, PassDims,
                        FwdPlan, int, unsigned long long*, FwdEnds);
  const Kern all[2][CL_NTMAX] = {
      {fwd_scan_cluster_kernel<1, false>, fwd_scan_cluster_kernel<2, false>,
       fwd_scan_cluster_kernel<3, false>, fwd_scan_cluster_kernel<4, false>},
      {fwd_scan_cluster_kernel<1, true>, fwd_scan_cluster_kernel<2, true>,
       fwd_scan_cluster_kernel<3, true>, fwd_scan_cluster_kernel<4, true>}};
  const Kern* kerns = all[ends.h0 || ends.c0 || ends.hT || ends.cT];
  cudaError_t err;
  for (int i = 0; i < CL_NTMAX; ++i) {
    const Kern kern = kerns[i];
    if (p.C > 8 && (err = cudaFuncSetAttribute(
                        kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                        1)) != cudaSuccess)
      return (int)err;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             CL_SMEM_MAX)) != cudaSuccess)
      return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(CL_THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  fits(rt_max);
  cfg.gridDim = dim3(p.C * ((R + rt_max - 1) / rt_max));
  cfg.dynamicSmemBytes = fwd_cluster_smem(p);
  if ((err = cudaOccupancyMaxActiveClusters(&p.active, kerns[p.NT - 1],
                                             &cfg)) != cudaSuccess)
    return (int)err;
  if (p.active == 0) return (int)cudaErrorInvalidConfiguration;
  fits(std::min(rt_max, (R + p.active - 1) / p.active));
  cfg.gridDim = dim3(p.C * ((R + p.RT - 1) / p.RT));
  cfg.dynamicSmemBytes = fwd_cluster_smem(p);
  err = cudaLaunchKernelEx(&cfg, kerns[p.NT - 1], (const bf16*)pre,
                           (bf16*)hs, (bf16*)cs, (const bf16*)u, d, p, hard,
                           prof, ends);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_scan_streamed(const void* pre, void* hs, void* cs, const void* u,
                      PassDims d, int hard, const FwdEnds& ends,
                      cudaStream_t st) {
  const int R = d.A * d.B, H4 = 4 * d.H, RB = SCAN_RB;
  const int nt = threads_for(H4);
  const size_t smem =
      sizeof(float) * (RB * (padk(d.H) + H4 + d.H) + nt * RB);
  auto kern = fwd_scan_streamed_kernel<T, SCAN_RB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<(R + RB - 1) / RB, nt, smem, st>>>((const T*)pre, (T*)hs, (T*)cs,
                                            (const T*)u, d, hard, ends);
  return (int)cudaGetLastError();
}

// 2., 5. of both forwards: P [M][4H] = (xin W -> T) + bias over all M
// rows (EPI_IN); xin [M][ldx] with K columns, w in the layout of T.
inline int launch_in(int bf16_, const void* xin, int ldx, int K,
                     const void* w, const void* bias, void* out, int M,
                     int H, cudaStream_t st) {
  const int H4 = 4 * H;
  if (bf16_) {
    const auto op = operand<bf16>(xin, ldx, 0, K, w, H4);
    const EpiArgs<bf16> e = {(bf16*)out, (const bf16*)bias};
    return gemm<bf16, EPI_IN>(op, op, M, H4, e, st);
  }
  const auto op = operand<float>(xin, ldx, 0, K, w, H4);
  const EpiArgs<float> e = {(float*)out, (const float*)bias};
  return gemm<float, EPI_IN>(op, op, M, H4, e, st);
}

// 3., 6. of both forwards: one layer's forward scan over P.  cluster =
// 1 (bfloat16 only): U resident in a thread-block cluster; cluster = 0:
// streamed.  prof (cluster scan only, may be null): three clock-cycle sums
// of the first block's steps and its plan, see fwd_scan_cluster_kernel.
// ends: see FwdEnds (the biaxial stacks pass none).
inline int launch_fwd_scan(int bf16_, int cluster, const void* pre,
                           void* hs, void* cs, const void* u, PassDims d,
                           int hard, unsigned long long* prof,
                           cudaStream_t st, const FwdEnds& ends = FwdEnds{}) {
  if (cluster) {
    if (!bf16_) return (int)cudaErrorInvalidValue;
    return fwd_scan_cluster(pre, hs, cs, u, d, hard, prof, ends, st);
  }
  if (bf16_)
    return fwd_scan_streamed<bf16>(pre, hs, cs, u, d, hard, ends, st);
  return fwd_scan_streamed<float>(pre, hs, cs, u, d, hard, ends, st);
}

}  // namespace biax
