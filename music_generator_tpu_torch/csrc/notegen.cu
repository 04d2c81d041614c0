// The generation pitch loop as one CUDA kernel for Hopper (sm_90a).
//
// Replaces music_generator_tpu/ops/pallas_notegen.py::pallas_note_sample
// (the Pallas kernel `_make_kernel`, launched by `pl.pallas_call` in
// `_build.run`).  One launch samples all N = 48 pitches of one generation
// timestep for G streams: per pitch, two note-axis LSTM cells, the sigmoid
// play/replay and linear volume heads, clip -> logit -> / T -> sigmoid,
// the `u <= p` Bernoulli draws, replay * play, clip(volume) * play, and the
// optional snap of the volume onto the k/127 velocity grid
// (gen_volume_quantize).  The chosen note n feeds pitch n + 1.
//
// The math is the Pallas kernel's, in float32: W0 split into its feature
// rows W0f [F, 4H] and chosen rows W0c [3, 4H]; the style terms folded by
// the wrapper into a0 = tanh(s Ws0 + bs0) W0 + b0 and a1 = tanh(s Ws1 +
// bs1) W1 + b1; z0 = (feat W0f + chosen W0c + a0) + h0 U0 and z1 = (h0 W1 +
// a1) + h1 U1; sigmoid as 1/(1+expf(-x)) (lax.logistic); temperature by
// true division; draws fire on u <= p.  Elementwise products and sums are
// written with __fmul_rn/__fadd_rn so that the compiler does not contract
// them into FMAs the plain PyTorch version does not use.  Built without
// --use_fast_math.
//
// What bounds it on this card.  The work per launch is about G * 31.6
// MFLOP (2 * 48 * (F*4H + 3*4H + 3*H*4H + 3*H) at F = 256, H = 128) and
// about 1.3 MB of float32 weights (W0f 512 KB; U0, W1, U1 256 KB each):
// at G = 3 some 1.4 us of float32 FMA at the H100's 67 TFLOP/s and 0.4 us
// of HBM at 3.35 TB/s.  Neither is the floor: the 48 pitches form a chain
// of dependent steps, each needing all of the weights, so the kernel is
// bound by how fast one SM can stream 1.3 MB from L2 per pitch.
//
// Design.  The weights (1.3 MB) do not fit in one SM's 227 KB of shared
// memory, so unlike the TPU's VMEM they are not resident: each block
// streams them from L2 (where they stay, 50 MB) once per pitch.  One block
// serves one stream, and thread j owns gate column j of the 4H columns
// (4H = 512 threads at H = 128).  Serving several streams per block would
// reuse each weight read, but a block's time is set by the latency of its
// own chain of L2 reads, not by the total L2 traffic, so blocks of one
// stream are no slower and the grid is simply G blocks.  h, c, z, the
// feature row and the chosen note live in shared memory, with
// __syncthreads() between the z, gate, head and sampling stages and a
// warp reduction for each of the three heads.  A later redesign can keep
// the weights resident in the distributed shared memory of a thread-block
// cluster.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float gate_f(float x, int hard) {
  // Keras 2 hard_sigmoid: clip(0.2x + 0.5, 0, 1).
  if (hard)
    return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, x), 0.5f), 0.f), 1.f);
  return sigmoid_f(x);
}

// The four-gate nonlinearity of z (i, f, g, o) into (h, c) in place; c
// stays float32.
__device__ __forceinline__ void lstm_gates(const float* z, float* h,
                                           float* c, int H, int hard,
                                           int tid, int nt) {
  for (int j = tid; j < H; j += nt) {
    const float ig = gate_f(z[j], hard);
    const float fg = gate_f(z[H + j], hard);
    const float gg = tanhf(z[2 * H + j]);
    const float og = gate_f(z[3 * H + j], hard);
    const float cn = __fadd_rn(__fmul_rn(fg, c[j]), __fmul_rn(ig, gg));
    c[j] = cn;
    h[j] = __fmul_rn(og, tanhf(cn));
  }
}

__global__ void __launch_bounds__(1024) notegen_kernel(
    const float* __restrict__ feats,     // [G, N, F]
    const float* __restrict__ uniforms,  // [G, N, 2]
    const float* __restrict__ temp,      // [G]
    const float* __restrict__ w0f,       // [F, 4H]
    const float* __restrict__ w0c,       // [3, 4H]
    const float* __restrict__ a0,        // [G, 4H]
    const float* __restrict__ u0,        // [H, 4H]
    const float* __restrict__ w1,        // [H, 4H]
    const float* __restrict__ a1,        // [G, 4H]
    const float* __restrict__ u1,        // [H, 4H]
    const float* __restrict__ wnd,       // [H, 2]
    const float* __restrict__ bnd,       // [2]
    const float* __restrict__ wvd,       // [H, 1]
    const float* __restrict__ bvd,       // [1]
    const float* __restrict__ vgrid,     // [max_velocity + 1], or null
    float* __restrict__ out,             // [G, N, 3]
    int N, int F, int H, int hard, int max_velocity) {
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  const int g = blockIdx.x;  // one block per stream
  const int tid = threadIdx.x;
  const int nt = blockDim.x;  // a multiple of 32, at least 3 warps
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* h0 = smem;      // [H]
  float* c0 = h0 + H;    // [H]
  float* h1 = c0 + H;    // [H]
  float* c1 = h1 + H;    // [H]
  float* z = c1 + H;     // [4H]
  float* x = z + H4;     // [F]  this pitch's feature row
  float* ch = x + F;     // [4]  chosen (play, replay, volume)
  float* hd = ch + 4;    // [4]  head outputs

  for (int i = tid; i < 4 * H; i += nt) smem[i] = 0.f;
  if (tid < 8) ch[tid] = 0.f;
  a0 += (size_t)g * H4;
  a1 += (size_t)g * H4;

  for (int n = 0; n < N; ++n) {
    const float* feat = feats + ((size_t)g * N + n) * F;
    for (int k = tid; k < F; k += nt) x[k] = feat[k];
    __syncthreads();

    // Layer 0: z0 = (feat W0f + chosen W0c + a0) + h0 U0.
    for (int j = tid; j < H4; j += nt) {
      float acc = 0.f, rec = 0.f;
#pragma unroll 8
      for (int k = 0; k < F; ++k)
        acc = fmaf(x[k], __ldg(w0f + (size_t)k * H4 + j), acc);
#pragma unroll 8
      for (int k = 0; k < H; ++k)
        rec = fmaf(h0[k], __ldg(u0 + (size_t)k * H4 + j), rec);
      float zc = __fmul_rn(ch[0], w0c[j]);
      zc = fmaf(ch[1], w0c[H4 + j], zc);
      zc = fmaf(ch[2], w0c[2 * H4 + j], zc);
      z[j] = __fadd_rn(__fadd_rn(__fadd_rn(acc, zc), a0[j]), rec);
    }
    __syncthreads();
    lstm_gates(z, h0, c0, H, hard, tid, nt);
    __syncthreads();

    // Layer 1: z1 = (h0 W1 + a1) + h1 U1.
    for (int j = tid; j < H4; j += nt) {
      float acc = 0.f, rec = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        acc = fmaf(h0[k], __ldg(w1 + (size_t)k * H4 + j), acc);
        rec = fmaf(h1[k], __ldg(u1 + (size_t)k * H4 + j), rec);
      }
      z[j] = __fadd_rn(__fadd_rn(acc, a1[j]), rec);
    }
    __syncthreads();
    lstm_gates(z, h1, c1, H, hard, tid, nt);
    __syncthreads();

    // Heads: the (play, replay) logits and the linear volume, one warp
    // each, reduced across the warp.
    if (warp < 3) {
      float sum = 0.f;
      for (int k = lane; k < H; k += 32)
        sum = fmaf(h1[k], warp < 2 ? wnd[k * 2 + warp] : wvd[k], sum);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0)
        hd[warp] = __fadd_rn(sum, warp < 2 ? bnd[warp] : bvd[0]);
    }
    __syncthreads();

    // Temperature, draws and volume, on one thread.
    if (tid == 0) {
      const float T = temp[g];
      float p[2];
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        float q = sigmoid_f(hd[o]);
        q = fminf(fmaxf(q, 1e-7f), (float)(1.0 - 1e-7));
        const float logit = -logf(__fsub_rn(1.f / q, 1.f));
        p[o] = sigmoid_f(logit / T);
      }
      const float* u = uniforms + ((size_t)g * N + n) * 2;
      const float play = u[0] <= p[0] ? 1.f : 0.f;
      const float replay = __fmul_rn(u[1] <= p[1] ? 1.f : 0.f, play);
      float v = fminf(fmaxf(hd[2], 0.f), 1.f);
      if (vgrid != nullptr) {
        v = vgrid[(int)rintf(__fmul_rn(v, (float)max_velocity))];
      }
      v = __fmul_rn(v, play);
      ch[0] = play;
      ch[1] = replay;
      ch[2] = v;
      float* o = out + ((size_t)g * N + n) * 3;
      o[0] = play;
      o[1] = replay;
      o[2] = v;
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry for ctypes.  Every pointer is a float32 CUDA buffer the
// caller allocated (contiguous, row-major, shapes as in notegen_kernel);
// `vgrid` may be null (no quantization).  Launches one block per stream on
// `stream` and returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int notegen_launch(
    const float* feats, const float* uniforms, const float* temp,
    const float* w0f, const float* w0c, const float* a0, const float* u0,
    const float* w1, const float* a1, const float* u1, const float* wnd,
    const float* bnd, const float* wvd, const float* bvd,
    const float* vgrid, float* out, int G, int N, int F, int H, int hard,
    int max_velocity, void* stream) {
  if (G <= 0 || N <= 0 || F <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(8 * H + F + 8);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        notegen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // One thread per gate column, at least 3 warps (one per head), at most
  // 1024 (the loops over j stride by the block size).
  int threads = 4 * H < 96 ? 96 : (4 * H + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  notegen_kernel<<<G, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      feats, uniforms, temp, w0f, w0c, a0, u0, w1, a1, u1, wnd, bnd, wvd,
      bvd, vgrid, out, N, F, H, hard, max_velocity);
  return (int)cudaGetLastError();
}
