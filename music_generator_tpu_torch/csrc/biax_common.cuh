// Shared pieces of the biaxial training kernels (biax_time.cu, biax_note.cu)
// for Hopper (sm_90a): compute-dtype arithmetic, the Murmur3 dropout masks
// of the Pallas kernels, the per-block row matrix-vector product, the LSTM
// cell forward and backward, and the weight-gradient reduction.
//
// Compute dtype.  Every kernel is a template on T = float or __nv_bfloat16.
// Values live in shared memory as float holding numbers representable in T;
// `rnd<T>` rounds a float to T (round to nearest even) the way a PyTorch
// operation on T-typed tensors rounds its result.  Products accumulate in
// float32.  Elementwise products and sums use __fmul_rn/__fadd_rn so the
// compiler does not contract them into FMAs that the plain version lacks.
// Built without --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace biax {

typedef __nv_bfloat16 bf16;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Cvt<bf16> {
  static __device__ __forceinline__ float to(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 from(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T>
__device__ __forceinline__ float ld(const T* p) { return Cvt<T>::to(*p); }
template <typename T>
__device__ __forceinline__ void st(T* p, float v) { *p = Cvt<T>::from(v); }
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Cvt<T>::to(Cvt<T>::from(v));
}
template <typename T>
__device__ __forceinline__ float add_t(float a, float b) {
  return rnd<T>(__fadd_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float mul_t(float a, float b) {
  return rnd<T>(__fmul_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float tanh_t(float x) { return rnd<T>(tanhf(x)); }

// The logistic as 0.5 * tanh(0.5 x) + 0.5, every step in T (pallas_lstm.py
// `_sigmoid`).
template <typename T>
__device__ __forceinline__ float sigmoid_t(float x) {
  return add_t<T>(mul_t<T>(0.5f, tanh_t<T>(mul_t<T>(0.5f, x))), 0.5f);
}

// The recurrent gate: the logistic, or Keras 2's hard_sigmoid
// clip(0.2 x + 0.5, 0, 1) with the constant 0.2 in T.
template <typename T>
__device__ __forceinline__ float gate_t(float x, int hard) {
  if (hard) {
    const float v = add_t<T>(mul_t<T>(x, rnd<T>(0.2f)), 0.5f);
    return fminf(fmaxf(v, 0.f), 1.f);
  }
  return sigmoid_t<T>(x);
}

// d gate / dz through the gate's output s (pallas_lstm.py `_gate_grad`).
__device__ __forceinline__ float gate_grad(float s, int hard) {
  if (hard) return (s > 0.f && s < 1.f) ? 0.2f : 0.f;
  return s * (1.f - s);
}

// ---------------------------------------------------------------------------
// Dropout: `_mask` of pallas_biax.py, bit for bit.  An element of a site of
// width W in TPU tile j at scan step s, at row r of the tile and column col,
// keeps when murmur3_fmix(r * W + col + base(seed, site, j, s)) >= thr.
// ---------------------------------------------------------------------------

// S_STACK_MID is the fused two-layer stack's inter-layer mask (lstm2.cu),
// which lstm2_masks.cu writes out.
enum Site { S_IN = 0, S_STYLE0 = 1, S_STYLE1 = 2, S_MID = 3, S_OUT = 4,
            S_STYLE0C = 5, S_STACK_MID = 6 };

struct Drop {
  uint32_t seed, thr;   // seed word; keep threshold computed on the host
  float scale;          // 1/keep in T
  int on;
};

__device__ __forceinline__ float mval(const Drop& d, int site, int j, int s,
                                      int r, int W, int col) {
  const uint32_t base = (d.seed * 0x9E3779B1u)
      ^ ((uint32_t)site * 0x85EBCA77u) ^ ((uint32_t)j * 0xC2B2AE3Du)
      ^ ((uint32_t)s * 0x27D4EB2Fu);
  uint32_t x = (uint32_t)(r * W + col) + base;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= d.thr ? d.scale : 0.f;
}

// A row g of the (across, batch) row space, in the TPU tiling: tile j and
// row r within the tile (k across-slices of B rows per tile).
struct RowPos { int a, b, j, r; };
__device__ __forceinline__ RowPos row_pos(int g, int B, int k) {
  RowPos p;
  p.a = g / B;
  p.b = g % B;
  p.j = p.a / k;
  p.r = (p.a % k) * B + p.b;
  return p;
}

// ---------------------------------------------------------------------------
// out(rr, c) = sum_{kk < K} in[rr * ldi + kk] * M(kk, c) for the RB <= 16 rows
// of a block and c < Wd; `epi(rr, c, sum)` consumes each sum.  `in` is in
// shared memory with a row stride ldi >= padk(K) and zeros from K to
// padk(K); M streams from L2.  Partial sums over parts of K go through
// `scratch` (at most blockDim.x * RB floats) and are combined in a fixed
// order, so the result does not depend on scheduling.  Ends with a barrier.
//
// float32: M is row-major [K][ldm]; a thread owns a column (and a part of
// K) and accumulates its RB rows with FMAs on the CUDA cores.
// bfloat16: M is the transposed layout [Wd][padk(K)] (zero-padded), and a
// warp owns 16 columns (and a part of K): tensor-core mma.sync m16n8k16
// with the 16 columns on the M side, the block's rows on the N side (one n8
// tile per 8 rows, sharing each weight fragment; rows past RB zero) and
// float32 accumulation.
// Each lane loads 16 contiguous bytes of a weight row per 32 values of K
// (full 32-byte sectors); the order of K inside the 32 is permuted the same
// way for both operands, which leaves the sum unchanged.
// ---------------------------------------------------------------------------
__host__ __device__ __forceinline__ int padk(int k) { return (k + 31) & ~31; }

// The row stride of the xtot tapes: rows 16-byte aligned for the
// weight-gradient reduction.
__host__ __device__ __forceinline__ int pad8(int k) { return (k + 7) & ~7; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int RB, typename Epi>
__device__ __forceinline__ void matvec_mma(const float* in, int ldi, int K,
                                           const bf16* __restrict__ MT,
                                           int Wd, float* scratch, Epi epi) {
  static_assert(RB <= 16, "the rows of a block fill at most two n8 tiles");
  constexpr int NT = (RB + 7) / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Kp = padk(K), tiles = (Wd + 15) / 16, blocks = Kp / 32;
  int P = nwarps / tiles;
  P = P < 1 ? 1 : (P > 8 ? 8 : P);
  const int per = (blocks + P - 1) / P;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int it = warp; it < tiles * P; it += nwarps) {
    const int tile = it % tiles, p = it / tiles;
    const int c0 = tile * 16, kb0 = p * per, kb1 = min(blocks, kb0 + per);
    // Lane (g, t) reads weight rows c0 + g and c0 + g + 8 and block row g,
    // K values 8t .. 8t + 7 of each 32.
    const uint4* A0 = c0 + g < Wd
        ? reinterpret_cast<const uint4*>(MT + (size_t)(c0 + g) * Kp + 8 * t)
        : nullptr;
    const uint4* A1 = c0 + g + 8 < Wd
        ? reinterpret_cast<const uint4*>(MT + (size_t)(c0 + g + 8) * Kp +
                                         8 * t)
        : nullptr;
    const float* xr = in + g * ldi + 8 * t;
    float d[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
#pragma unroll 4
    for (int kb = kb0; kb < kb1; ++kb) {
      const uint4 a = A0 ? __ldg(A0 + kb * 4) : zero4;
      const uint4 c = A1 ? __ldg(A1 + kb * 4) : zero4;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0 = 0u, b1 = 0u, b2 = 0u, b3 = 0u;
        if (8 * n + g < RB) {
          const float* x = xr + 8 * n * ldi + kb * 32;
          const float4 v0 = *reinterpret_cast<const float4*>(x);
          const float4 v1 = *reinterpret_cast<const float4*>(x + 4);
          b0 = pack_bf16(v0.x, v0.y);
          b1 = pack_bf16(v0.z, v0.w);
          b2 = pack_bf16(v1.x, v1.y);
          b3 = pack_bf16(v1.z, v1.w);
        }
        mma_bf16(d[n], a.x, c.x, a.y, c.y, b0, b1);
        mma_bf16(d[n], a.z, c.z, a.w, c.w, b2, b3);
      }
    }
    // d[n][0], d[n][1]: column c0 + g, rows 8n + 2t, 8n + 2t + 1;
    // d[n][2], d[n][3]: column c0 + g + 8.
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = 8 * n + 2 * t + (q & 1), col = c0 + g + 8 * (q >> 1);
        if (rr < RB && col < Wd) {
          if (P == 1)
            epi(rr, col, d[n][q]);
          else
            scratch[(p * RB + rr) * Wd + col] = d[n][q];
        }
      }
  }
  if (P > 1) {
    __syncthreads();
    for (int it = threadIdx.x; it < RB * Wd; it += blockDim.x) {
      const int rr = it / Wd, c = it % Wd;
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += scratch[(p * RB + rr) * Wd + c];
      epi(rr, c, s);
    }
  }
  __syncthreads();
}

template <int RB, typename Epi>
__device__ __forceinline__ void matvec_fma(const float* in, int ldi, int K,
                                           const float* __restrict__ M,
                                           int ldm, int Wd, float* scratch,
                                           Epi epi) {
  const int nt = blockDim.x, tid = threadIdx.x;
  int P = nt / Wd;
  P = P < 1 ? 1 : (P > 8 ? 8 : P);
  const int chunk = (K + P - 1) / P;
  for (int it = tid; it < Wd * P; it += nt) {
    const int c = it % Wd, p = it / Wd;
    const int k0 = p * chunk, k1 = min(K, k0 + chunk);
    float acc[RB];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) acc[rr] = 0.f;
    // Unrolled so several independent weight loads are in flight: the loop
    // is bound by L2 latency, not by the FMAs.
#pragma unroll 8
    for (int kk = k0; kk < k1; ++kk) {
      const float w = M[(size_t)kk * ldm + c];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
        acc[rr] = fmaf(in[rr * ldi + kk], w, acc[rr]);
    }
    if (P == 1) {
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) epi(rr, c, acc[rr]);
    } else {
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
        scratch[(p * RB + rr) * Wd + c] = acc[rr];
    }
  }
  if (P > 1) {
    __syncthreads();
    for (int it = tid; it < RB * Wd; it += nt) {
      const int rr = it / Wd, c = it % Wd;
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += scratch[(p * RB + rr) * Wd + c];
      epi(rr, c, s);
    }
  }
  __syncthreads();
}

// The product in the layout of T: M is [K][Wd] for float32, [Wd][padk(K)]
// for bfloat16 (see above).
template <typename T, int RB, typename Epi>
__device__ __forceinline__ void matvec(const float* in, int ldi, int K,
                                       const T* __restrict__ M, int Wd,
                                       float* scratch, Epi epi) {
  if constexpr (std::is_same<T, bf16>::value)
    matvec_mma<RB>(in, ldi, K, M, Wd, scratch, epi);
  else
    matvec_fma<RB>(in, ldi, K, M, Wd, Wd, scratch, epi);
}

// The gates of pre-activation row zr at unit j: (i, f, g, o) in T.
struct Gates { float i, f, g, o; };
template <typename T>
__device__ __forceinline__ Gates gates(const float* zr, int H, int j,
                                       int hard) {
  Gates q;
  q.i = gate_t<T>(zr[j], hard);
  q.f = gate_t<T>(zr[H + j], hard);
  q.g = tanh_t<T>(zr[2 * H + j]);
  q.o = gate_t<T>(zr[3 * H + j], hard);
  return q;
}

// c' = f c + (i g -> T) in float32; returns c', and h' (rounded to T, the
// only form in which h is ever read) in *h.
template <typename T>
__device__ __forceinline__ float cell(const Gates& q, float c, float* h) {
  const float cn = __fadd_rn(__fmul_rn(q.f, c), mul_t<T>(q.i, q.g));
  *h = rnd<T>(__fmul_rn(q.o, tanh_t<T>(rnd<T>(cn))));
  return cn;
}

// tanh(c' -> T) as float, recomputed from the gates and the previous c.
template <typename T>
__device__ __forceinline__ float tanh_c(const Gates& q, float c_prev) {
  const float cn = __fadd_rn(__fmul_rn(q.f, c_prev), mul_t<T>(q.i, q.g));
  return tanh_t<T>(rnd<T>(cn));
}

// The cell backward (pallas_lstm2.py `_cell_bwd`): dz (4 values, rounded to
// T) into dz[j], dz[H+j], ...; returns dc_prev = dc * f.
template <typename T>
__device__ __forceinline__ float cell_bwd(const Gates& q, float c_prev,
                                          float tc, float dh, float dc_carry,
                                          int hard, float* dz, int H, int j) {
  const float d_o = dh * tc;
  const float dc = dc_carry + dh * q.o * (1.f - tc * tc);
  dz[j] = rnd<T>(dc * q.g * gate_grad(q.i, hard));
  dz[H + j] = rnd<T>(dc * c_prev * gate_grad(q.f, hard));
  dz[2 * H + j] = rnd<T>(dc * q.i * (1.f - q.g * q.g));
  dz[3 * H + j] = rnd<T>(d_o * gate_grad(q.o, hard));
  return dc * q.f;
}

// ---------------------------------------------------------------------------
// The weight gradients.  The TPU kernels accumulate dW = sum x^T dz over all
// tiles and steps in VMEM; here the recurrence kernels write the dz tapes
// and this reduction computes
//     out[K][M] = sum_{r < rows} A[r - shift][:K]^T  Bm[r][:M]
// (A rows before `shift` read as zero: the previous-h operand; A null gives
// the column sums of Bm: the bias gradient) in float32.  Blocks own an
// output tile and one chunk of rows each; the chunks' partial sums are
// added in a fixed order by a second kernel, so the result is the same on
// every run.  The float32 reduction below runs on the CUDA cores (64 x 64
// tiles, 256 threads, 4 x 4 outputs each).
// ---------------------------------------------------------------------------
template <typename TA, typename TB>
__global__ void __launch_bounds__(256) wgrad_partial_kernel(
    const TA* __restrict__ A, int lda, int shift,
    const TB* __restrict__ Bm, int ldb, int rows, int K, int M,
    int rows_per_chunk, float* __restrict__ ws) {
  __shared__ float As[16][64];
  __shared__ float Bs[16][65];
  const int k0 = blockIdx.y * 64, m0 = blockIdx.x * 64;
  const int chunk = blockIdx.z;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r = r0; r < r1; r += 16) {
    for (int e = threadIdx.x; e < 16 * 64; e += 256) {
      const int rr = e / 64, cc = e % 64, row = r + rr;
      float a = 0.f, b = 0.f;
      if (row < r1) {
        const int kk = k0 + cc, mm = m0 + cc, ar = row - shift;
        if (kk < K && ar >= 0) a = ld(A + (size_t)ar * lda + kk);
        if (mm < M) b = ld(Bm + (size_t)row * ldb + mm);
      }
      As[rr][cc] = a;
      Bs[rr][cc] = b;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < 16; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k0 + ty * 4 + i, mm = m0 + tx + 16 * j;
      if (kk < K && mm < M)
        ws[((size_t)chunk * K + kk) * M + mm] = acc[i][j];
    }
}

// The bfloat16 reduction on the tensor cores, for operands whose rows are
// 16-byte aligned (lda, ldb multiples of 8): blocks of 128 threads own a
// 64 x 64 output tile and stage 32 rows of A and Bm at a time in shared
// memory as they lie in memory ([row][feature], 16-byte loads);
// ldmatrix.trans turns them into the fragments of A^T and Bm, and each warp
// runs mma.sync m16n8k16 over a 32 x 32 part of the tile with float32
// accumulation.  Columns of A past K (a tape's row padding) only reach
// output rows that are not stored.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// ldmatrix without transpose: the four 8 x 8 matrices whose rows lanes
// 0-7, 8-15, 16-23, 24-31 address (a: shared-state-space address).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  ldsm_x4(r, (uint32_t)__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(128) wgrad_mma_kernel(
    const bf16* __restrict__ A, int lda, int shift,
    const bf16* __restrict__ Bm, int ldb, int rows, int K, int M,
    int rows_per_chunk, float* __restrict__ ws) {
  constexpr int LD = 72;          // 64 + 8: 16-byte rows, no bank conflicts
  __shared__ __align__(16) bf16 As[32 * LD];
  __shared__ __align__(16) bf16 Bs[32 * LD];
  const int k0 = blockIdx.y * 64, m0 = blockIdx.x * 64;
  const int chunk = blockIdx.z;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, i8 = lane & 7;
  const int wk = (warp >> 1) * 32, wm = (warp & 1) * 32;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int r = r0; r < r1; r += 32) {
#pragma unroll
    for (int e = threadIdx.x; e < 32 * 8; e += 128) {
      const int rr = e >> 3, c8 = (e & 7) * 8, row = r + rr;
      const int ar = row - shift;
      uint4 a = zero4, b = zero4;
      if (row < r1) {
        if (ar >= 0 && k0 + c8 < lda)
          a = __ldg(reinterpret_cast<const uint4*>(
              A + (size_t)ar * lda + k0 + c8));
        if (m0 + c8 < ldb)
          b = __ldg(reinterpret_cast<const uint4*>(
              Bm + (size_t)row * ldb + m0 + c8));
      }
      *reinterpret_cast<uint4*>(As + rr * LD + c8) = a;
      *reinterpret_cast<uint4*>(Bs + rr * LD + c8) = b;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 32; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
      // A^T fragments: matrix q of the x4 covers rows ks + 8 (q >> 1) .. +7
      // and features 8 (q & 1) .. +7 of the 16 x 16 block.
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4_trans(af[mt], As + (ks + 8 * (q >> 1) + i8) * LD + wk +
                                  mt * 16 + 8 * (q & 1));
      // Bm fragments for n tiles nt, nt + 1: matrix q covers rows
      // ks + 8 (q & 1) .. +7 and columns of tile nt + (q >> 1).
#pragma unroll
      for (int nt = 0; nt < 4; nt += 2) {
        uint32_t v[4];
        ldsm_x4_trans(v, Bs + (ks + 8 * (q & 1) + i8) * LD + wm +
                             (nt + (q >> 1)) * 8);
        bfr[nt][0] = v[0];
        bfr[nt][1] = v[1];
        bfr[nt + 1][0] = v[2];
        bfr[nt + 1][1] = v[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                   bfr[nt][0], bfr[nt][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k0 + wk + mt * 16 + g + 8 * (e >> 1);
        const int mm = m0 + wm + nt * 8 + 2 * t + (e & 1);
        if (kk < K && mm < M)
          ws[((size_t)chunk * K + kk) * M + mm] = acc[mt][nt][e];
      }
}

// The bias gradient: column sums of Bm over a chunk of rows.  A block of
// 256 threads owns 32 columns; 8 row lanes each sum every 8th row, and the
// 8 lanes are added in a fixed order.
template <typename TB>
__global__ void __launch_bounds__(256) colsum_partial_kernel(
    const TB* __restrict__ Bm, int ldb, int rows, int M, int rows_per_chunk,
    float* __restrict__ ws) {
  __shared__ float part[8][32];
  const int c = threadIdx.x & 31, lane8 = threadIdx.x >> 5;
  const int m = blockIdx.x * 32 + c;
  const int chunk = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  float s = 0.f;
  if (m < M)
    for (int r = r0 + lane8; r < r1; r += 8) s += ld(Bm + (size_t)r * ldb + m);
  part[lane8][c] = s;
  __syncthreads();
  if (lane8 == 0 && m < M) {
    float tot = 0.f;
    for (int l = 0; l < 8; ++l) tot += part[l][c];
    ws[(size_t)chunk * M + m] = tot;
  }
}

__global__ void wgrad_sum_kernel(const float* __restrict__ ws, int chunks,
                                 int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += ws[(size_t)c * n + i];
  out[i] = s;
}

template <typename TA, typename TB>
void wgrad_launch(const void* A, int lda, int shift, const void* Bm, int ldb,
                  int rows, int K, int M, int chunks, int rows_per_chunk,
                  float* ws, cudaStream_t st) {
  const dim3 grid((M + 63) / 64, (K + 63) / 64, chunks);
  wgrad_partial_kernel<TA, TB><<<grid, 256, 0, st>>>(
      (const TA*)A, lda, shift, (const TB*)Bm, ldb, rows, K, M,
      rows_per_chunk, ws);
}

}  // namespace biax

// kinds: 0 = none (column sums of Bm), 1 = float32, 2 = bfloat16; lda and
// ldb are the row strides of A and Bm.  `ws` holds
// at least chunks * K * M floats.  Returns the CUDA error code (0 = ok).
extern "C" int biax_wgrad(int a_kind, const void* A, int lda, int shift,
                          int b_kind, const void* Bm, int ldb, int rows,
                          int K, int M, int chunks, float* ws, float* out,
                          void* stream) {
  using namespace biax;
  cudaStream_t st = (cudaStream_t)stream;
  int rpc = (rows + chunks - 1) / chunks;
  rpc = ((rpc + 31) / 32) * 32;
  chunks = (rows + rpc - 1) / rpc;
  if (a_kind == 0) {                       // bias: column sums
    const dim3 grid((M + 31) / 32, chunks);
    if (b_kind == 2)
      colsum_partial_kernel<bf16><<<grid, 256, 0, st>>>(
          (const bf16*)Bm, ldb, rows, M, rpc, ws);
    else
      colsum_partial_kernel<float><<<grid, 256, 0, st>>>(
          (const float*)Bm, ldb, rows, M, rpc, ws);
  } else if (a_kind == 2 && b_kind == 2 && lda % 8 == 0 && ldb % 8 == 0) {
    const dim3 grid((M + 63) / 64, (K + 63) / 64, chunks);
    wgrad_mma_kernel<<<grid, 128, 0, st>>>((const bf16*)A, lda, shift,
                                           (const bf16*)Bm, ldb, rows, K, M,
                                           rpc, ws);
  } else if (a_kind == 2 && b_kind == 2) {
    wgrad_launch<bf16, bf16>(A, lda, shift, Bm, ldb, rows, K, M, chunks,
                             rpc, ws, st);
  } else if (a_kind == 2) {
    wgrad_launch<bf16, float>(A, lda, shift, Bm, ldb, rows, K, M, chunks,
                              rpc, ws, st);
  } else if (b_kind == 2) {
    wgrad_launch<float, bf16>(A, lda, shift, Bm, ldb, rows, K, M, chunks,
                              rpc, ws, st);
  } else {
    wgrad_launch<float, float>(A, lda, shift, Bm, ldb, rows, K, M, chunks,
                               rpc, ws, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = K * M;
  wgrad_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(ws, chunks, n, out);
  return (int)cudaGetLastError();
}
