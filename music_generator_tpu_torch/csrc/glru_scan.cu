// The linear time axis's gated linear recurrence (minGRU-style), forward and
// backward, one launch each a layer, as CUDA kernels for Hopper (sm_90a).
//
//   g_t = sigmoid(P_t[:H] + b[:H]),  z_t = tanh(P_t[H:] + b[H:])
//   h_t = (1 - g_t) h_{t-1} + g_t z_t,  h_{-1} = 0
//
// with P = xs W [S, R, 2H] in the compute dtype (a cuBLAS product outside
// these kernels) and the bias b [2H] float32.
//
// Replaces no TPU kernel: the JAX package runs the recurrence as
// `jax.lax.associative_scan`, which XLA lowers to elementwise operations.  The
// port ran the same odd/even tree as PyTorch operations (ops/linear_scan.py::
// associative_scan): ~56 launches forward and ~91 backward a layer, each a
// pass over [S / 2^k, R, H] slices, plus the gates' ~13.  Here the recurrence
// runs sequentially along t, since its R H chains (786,432 at B 64) are
// independent: one thread walks VEC chains of one row in registers, float32
// throughout, and nothing is stored but what the layer returns.
//
//   glru_fwd_kernel   reads P, writes hs (h rounded once, to the compute
//                     dtype);
//   glru_bwd_kernel   walks t backwards: recomputes g and z from P, carries
//                     dH_t = dhs_t + a_{t+1} dH_{t+1} (a = 1 - g) in float32,
//                     takes h_{t-1} from the saved, ROUNDED hs[t - 1], writes
//                     dP_t for both halves (rounded) and each block's float32
//                     sums of dP over its rows and all t, which the wrapper
//                     adds over the blocks (one reduction) into db.
//
// Arithmetic.  Each operation is a rounded float32 intrinsic (__fadd_rn,
// __fmul_rn, __fsub_rn, __fdiv_rn), which the compiler never contracts into
// an FMA, in the order of the plain version (ops/linear_scan.py::
// glru_fwd_reference / glru_bwd_reference, one PyTorch operation a step);
// sigmoid is 1 / (1 + expf(-x)) and tanh tanhf, as PyTorch's CUDA kernels
// compute them; the build has no fast math.  Only db's sum runs in another
// order than the plain version's.  Nothing is summed across threads but db,
// in a fixed order, so a launch is deterministic.
//
// What bounds it on this card.  Bytes: the forward reads P and writes hs
// (3 S R H elements), the backward reads P, hs, dhs and writes dP (6 S R H);
// at S 128, R 3,072, H 256 in bfloat16 that is 0.180 and 0.361 ms at 3.35
// TB/s.  Every load and store is 16 bytes (8 bfloat16 or 4 float32 units of
// one row; H a multiple of that), neighbouring threads on neighbouring units,
// and each thread keeps the loads of its next kAhead steps in flight (a ring
// of registers, refilled kAhead steps ahead of the chain that uses them).
// Measured at those shapes in bfloat16 (H100 80GB HBM3, 700 W, L2 rewritten):
// forward 0.219 ms (0.82 of the bound), backward 0.462 ms (0.78); a ring of
// 1 step read the same, of 4 or 8 slower (0.287 / 0.323 and 0.495 / 0.589
// ms: more registers, fewer blocks resident), and blocks of 128 threads or
// a forced third block an SM no faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads of a block (bx units x by rows)
constexpr int kAhead = 2;         // steps of loads a thread keeps in flight

// A 16-byte load or store: four 32-bit words of one row's consecutive units.
template <typename T> struct Fmt;

template <> struct Fmt<float> {
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ void unpack(unsigned w, float* f) {
    f[0] = __uint_as_float(w);
  }
  static __device__ __forceinline__ unsigned pack(const float* f) {
    return __float_as_uint(f[0]);
  }
};

template <> struct Fmt<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  // A bfloat16's bits are a float32's top half: widening is exact.
  static __device__ __forceinline__ void unpack(unsigned w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  // Round to nearest even, as PyTorch's float32 -> bfloat16 conversion.
  static __device__ __forceinline__ unsigned pack(const float* f) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[1]));
    return lo | (hi << 16);
  }
};

template <typename T>
constexpr int kVec = 4 * Fmt<T>::kPerWord;     // units a 16-byte access holds

template <typename T>
__device__ __forceinline__ void unpack4(const uint4& v, float* f) {
  constexpr int k = Fmt<T>::kPerWord;
  Fmt<T>::unpack(v.x, f);
  Fmt<T>::unpack(v.y, f + k);
  Fmt<T>::unpack(v.z, f + 2 * k);
  Fmt<T>::unpack(v.w, f + 3 * k);
}

template <typename T>
__device__ __forceinline__ uint4 pack4(const float* f) {
  constexpr int k = Fmt<T>::kPerWord;
  return make_uint4(Fmt<T>::pack(f), Fmt<T>::pack(f + k),
                    Fmt<T>::pack(f + 2 * k), Fmt<T>::pack(f + 3 * k));
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// PyTorch's CUDA sigmoid: 1 / (1 + exp(-x)).
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    glru_fwd_kernel(const T* __restrict__ P, const float* __restrict__ bias,
                    T* __restrict__ hs, int S, int R, int H) {
  constexpr int V = kVec<T>, U = kAhead;
  const int u0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (u0 >= H || r >= R) return;
  const long long pstep = 2LL * R * H, hstep = static_cast<long long>(R) * H;
  const T* pg = P + 2LL * r * H + u0;
  const T* pz = pg + H;
  T* out = hs + static_cast<long long>(r) * H + u0;
  float bg[V], bz[V], h[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    bg[k] = bias[u0 + k];
    bz[k] = bias[H + u0 + k];
    h[k] = 0.0f;
  }
  uint4 rg[U], rz[U];            // the loads of steps t .. t + U - 1
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < S) {
      rg[u] = load16(pg + u * pstep);
      rz[u] = load16(pz + u * pstep);
    }
  }
  for (int t0 = 0; t0 < S; t0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < S) {
        float g[V], z[V];
        unpack4<T>(rg[u], g);
        unpack4<T>(rz[u], z);
        if (t + U < S) {
          rg[u] = load16(pg + (t + U) * pstep);
          rz[u] = load16(pz + (t + U) * pstep);
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float gk = sigmoid(__fadd_rn(g[k], bg[k]));
          const float zk = tanhf(__fadd_rn(z[k], bz[k]));
          h[k] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, gk), h[k]),
                           __fmul_rn(gk, zk));
        }
        store16(out + t * hstep, pack4<T>(h));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    glru_bwd_kernel(const T* __restrict__ P, const float* __restrict__ bias,
                    const T* __restrict__ hs, const T* __restrict__ dhs,
                    T* __restrict__ dP, float* __restrict__ dbias_part,
                    int S, int R, int H) {
  constexpr int V = kVec<T>, U = kAhead;
  __shared__ float red[kThreads * 2 * V];
  const int u0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  float sg[V], sz[V];            // this thread's sums of dP over t
#pragma unroll
  for (int k = 0; k < V; ++k) sg[k] = sz[k] = 0.0f;
  if (u0 < H && r < R) {
    const long long pstep = 2LL * R * H, hstep = static_cast<long long>(R) * H;
    const T* pg = P + 2LL * r * H + u0;
    const T* pz = pg + H;
    const T* hr = hs + static_cast<long long>(r) * H + u0;
    const T* dh = dhs + static_cast<long long>(r) * H + u0;
    T* dpg = dP + 2LL * r * H + u0;
    T* dpz = dpg + H;
    float bg[V], bz[V], dH[V], an[V];   // an: a_{t+1}, 0 past the end
#pragma unroll
    for (int k = 0; k < V; ++k) {
      bg[k] = bias[u0 + k];
      bz[k] = bias[H + u0 + k];
      dH[k] = an[k] = 0.0f;
    }
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    // The loads of steps t, t - 1, ..., t - U + 1: P's halves, dhs, and
    // hs[t - 1] (zero at t = 0).
    uint4 rg[U], rz[U], rd[U], rh[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = S - 1 - u;
      if (t >= 0) {
        rg[u] = load16(pg + t * pstep);
        rz[u] = load16(pz + t * pstep);
        rd[u] = load16(dh + t * hstep);
        rh[u] = t > 0 ? load16(hr + (t - 1) * hstep) : zero;
      }
    }
    for (int t0 = 0; t0 < S; t0 += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = S - 1 - (t0 + u);
        if (t >= 0) {
          float g[V], z[V], d[V], hp[V], og[V], oz[V];
          unpack4<T>(rg[u], g);
          unpack4<T>(rz[u], z);
          unpack4<T>(rd[u], d);
          unpack4<T>(rh[u], hp);
          const int n = t - U;
          if (n >= 0) {
            rg[u] = load16(pg + n * pstep);
            rz[u] = load16(pz + n * pstep);
            rd[u] = load16(dh + n * hstep);
            rh[u] = n > 0 ? load16(hr + (n - 1) * hstep) : zero;
          }
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float gk = sigmoid(__fadd_rn(g[k], bg[k]));
            const float zk = tanhf(__fadd_rn(z[k], bz[k]));
            const float ak = __fsub_rn(1.0f, gk);
            dH[k] = __fadd_rn(d[k], __fmul_rn(an[k], dH[k]));
            const float dg = __fmul_rn(dH[k], __fsub_rn(zk, hp[k]));
            const float dz = __fmul_rn(dH[k], gk);
            og[k] = __fmul_rn(__fmul_rn(dg, gk), ak);
            oz[k] = __fmul_rn(dz, __fsub_rn(1.0f, __fmul_rn(zk, zk)));
            sg[k] = __fadd_rn(sg[k], og[k]);
            sz[k] = __fadd_rn(sz[k], oz[k]);
            an[k] = ak;
          }
          store16(dpg + t * pstep, pack4<T>(og));
          store16(dpz + t * pstep, pack4<T>(oz));
        }
      }
    }
  }
  // The block's sums over its rows, in row order: one row of dbias_part
  // [gridDim.y, 2H] for each block row, the gate half then the candidate
  // half.
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    red[tid * 2 * V + k] = sg[k];
    red[tid * 2 * V + V + k] = sz[k];
  }
  __syncthreads();
  const int cols = blockDim.x * 2 * V;
  for (int e = tid; e < cols; e += blockDim.x * blockDim.y) {
    const int x = e / (2 * V), k = e % (2 * V);
    float s = 0.0f;
    for (int y = 0; y < static_cast<int>(blockDim.y); ++y)
      s = __fadd_rn(s, red[(y * blockDim.x + x) * 2 * V + k]);
    const int unit = (blockIdx.x * blockDim.x + x) * V + k % V;
    if (unit < H)
      dbias_part[static_cast<long long>(blockIdx.y) * 2 * H + (k / V) * H +
                 unit] = s;
  }
}

template <typename T>
int fwd(const void* P, const float* bias, void* hs, int S, int R, int H,
        dim3 grid, dim3 block, cudaStream_t st) {
  glru_fwd_kernel<T><<<grid, block, 0, st>>>(
      static_cast<const T*>(P), bias, static_cast<T*>(hs), S, R, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* P, const float* bias, const void* hs, const void* dhs,
        void* dP, float* part, int S, int R, int H, dim3 grid, dim3 block,
        cudaStream_t st) {
  glru_bwd_kernel<T><<<grid, block, 0, st>>>(
      static_cast<const T*>(P), bias, static_cast<const T*>(hs),
      static_cast<const T*>(dhs), static_cast<T*>(dP), part, S, R, H);
  return static_cast<int>(cudaGetLastError());
}

// The launch's grid and block for blocks of bx threads along the units (V
// units each) by `by` rows; false when the shape or the block is not one
// the kernels take.
bool plan(int bf16, int R, int H, int bx, int by, dim3* grid, dim3* block) {
  const int v = bf16 ? kVec<__nv_bfloat16> : kVec<float>;
  if (H <= 0 || R <= 0 || H % v != 0 || bx <= 0 ||
      by <= 0 || bx * by > kThreads || R > 65535LL * by)
    return false;
  *block = dim3(bx, by);
  *grid = dim3((H / v + bx - 1) / bx, (R + by - 1) / by);
  return true;
}

}  // namespace

// The units a thread takes and the threads a block may hold, for the
// wrapper to check against its own.
extern "C" int glru_layout(int* vec_bf16, int* vec_f32, int* threads) {
  *vec_bf16 = kVec<__nv_bfloat16>;
  *vec_f32 = kVec<float>;
  *threads = kThreads;
  return 0;
}

// hs [S, R, H] from P [S, R, 2H] (bfloat16 when bf16, else float32) and
// bias [2H] float32, on `stream`, with blocks of bx x by threads.  Returns
// the CUDA error of the launch (0 = ok).
extern "C" int glru_fwd(int bf16, const void* P, const float* bias,
                        void* hs, int S, int R, int H, int bx, int by,
                        void* stream) {
  dim3 grid, block;
  if (S <= 0 || !plan(bf16, R, H, bx, by, &grid, &block))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(P, bias, hs, S, R, H, grid, block, st)
              : fwd<float>(P, bias, hs, S, R, H, grid, block, st);
}

// dP [S, R, 2H] and dbias_part [gridDim.y, 2H] float32 (each block row's
// sums of dP over its rows and every step, before rounding) from P, bias,
// the forward's hs and the cotangent dhs [S, R, H], as glru_fwd's launch.
extern "C" int glru_bwd(int bf16, const void* P, const float* bias,
                        const void* hs, const void* dhs, void* dP,
                        float* dbias_part, int S, int R, int H, int bx,
                        int by, void* stream) {
  dim3 grid, block;
  if (S <= 0 || !plan(bf16, R, H, bx, by, &grid, &block))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(P, bias, hs, dhs, dP, dbias_part, S, R,
                                   H, grid, block, st)
              : bwd<float>(P, bias, hs, dhs, dP, dbias_part, S, R, H, grid,
                           block, st);
}
