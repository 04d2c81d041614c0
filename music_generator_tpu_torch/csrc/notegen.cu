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
// Two kernels compute this, bit for bit alike: every element of z is the
// same chain of fmaf in k order, associated as ((acc_F + zc) + a0) + rec
// and (acc + a1) + rec, and the cells, heads and draws share their code.
//
// What bounds it on this card.  The work per launch is about G * 31.6
// MFLOP (2 * 48 * (F*4H + 3*4H + 3*H*4H + 3*H) at F = 256, H = 128) and
// about 1.3 MB of float32 weights (W0f 512 KB; U0, W1, U1 256 KB each):
// at G = 3 some 1.4 us of float32 FMA at the H100's 67 TFLOP/s and 0.4 us
// of HBM at 3.35 TB/s.  Neither is the floor: the 48 pitches form a chain
// of dependent steps, and each step needs the recurrent weights.
//
// notegen_cluster_kernel, the one the wrapper launches.  Only h0 U0, h1 U1,
// chosen W0c and h0 W1 carry from pitch to pitch; feat W0f does not.  So
// (1) a prologue in the same launch computes acc_F = feat W0f for every
// pitch and stream of the cluster, each block for its own gate columns,
// with its W0f column slice and x staged in shared memory by cp.async,
// and keeps acc_F in shared memory; (2) the carrying weights (U0, W1, U1:
// 768 KB at H = 128) stay resident in the shared memory of a thread-block
// cluster of C blocks: block q owns the units [q H/C, (q+1) H/C) and the
// 4 H/C gate columns {a H + j} of them, so its gate sums land in its own
// shared memory and only h crosses blocks.  A cluster serves Gc streams.
// A block's warps have three roles: work warps (a product thread owns two
// columns and four streams, so each weight read serves eight chains; a
// cell thread one unit and stream), rec warps (h1 U1, which depends only
// on the previous pitch) and three head warps.  Per pitch: h0 U0 and h1 U1
// while the head warps compute the heads and draws of the previous pitch
// from the full h1 (every block itself, 3 H MACs a stream, so the chosen
// note needs no exchange; block 0 writes the output); then z0 with the
// chosen note, the cells of the block's units, its slice of h0 written to
// every peer through distributed shared memory, cluster barrier 1; h0 W1
// from the full h0 plus a1 and h1 U1, the cells, its slice of h1 to every
// peer, cluster barrier 2.  h0 and h1 alternate between two buffers by
// pitch: a peer's next write to a buffer comes after a cluster barrier
// that every reader of it has passed.  The plan (C, Gc, clusters, shared
// bytes) is `ng_plan`, mirrored by ops/notegen.py::notegen_plan; the
// launch refuses a plan that disagrees with it.
//
// notegen_streamed_kernel, kept to hold the cluster kernel to bit for bit
// and to time it against: one block per stream, thread j owns gate column
// j and streams all 1.3 MB of weights from L2 at every pitch; its time is
// the latency of that chain of L2 reads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

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

// One unit's LSTM cell from its four gate sums (i, f, g, o): updates c
// (float32) and returns h.
__device__ __forceinline__ float cell_f(float zi, float zf, float zg,
                                        float zo, float* c, int hard) {
  const float ig = gate_f(zi, hard);
  const float fg = gate_f(zf, hard);
  const float gg = tanhf(zg);
  const float og = gate_f(zo, hard);
  const float cn = __fadd_rn(__fmul_rn(fg, *c), __fmul_rn(ig, gg));
  *c = cn;
  return __fmul_rn(og, tanhf(cn));
}

// Temperature, draws and volume of one stream at one pitch from its head
// outputs hd[0..2] and uniforms (ua, ub): res = (play, replay * play,
// volume * play).
__device__ __forceinline__ void draw_note(const float* hd, float T, float ua,
                                          float ub, const float* vgrid,
                                          int max_velocity, float* res) {
  float p[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    float q = sigmoid_f(hd[o]);
    q = fminf(fmaxf(q, 1e-7f), (float)(1.0 - 1e-7));
    const float logit = -logf(__fsub_rn(1.f / q, 1.f));
    p[o] = sigmoid_f(logit / T);
  }
  const float play = ua <= p[0] ? 1.f : 0.f;
  const float replay = __fmul_rn(ub <= p[1] ? 1.f : 0.f, play);
  float v = fminf(fmaxf(hd[2], 0.f), 1.f);
  if (vgrid != nullptr) {
    v = vgrid[(int)rintf(__fmul_rn(v, (float)max_velocity))];
  }
  res[0] = play;
  res[1] = replay;
  res[2] = __fmul_rn(v, play);
}

// The four-gate nonlinearity of z (i, f, g, o) into (h, c) in place.
__device__ __forceinline__ void lstm_gates(const float* z, float* h,
                                           float* c, int H, int hard,
                                           int tid, int nt) {
  for (int j = tid; j < H; j += nt)
    h[j] = cell_f(z[j], z[H + j], z[2 * H + j], z[3 * H + j], c + j, hard);
}

__global__ void __launch_bounds__(1024) notegen_streamed_kernel(
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
      const float* u = uniforms + ((size_t)g * N + n) * 2;
      float res[3];
      draw_note(hd, temp[g], u[0], u[1], vgrid, max_velocity, res);
      float* o = out + ((size_t)g * N + n) * 3;
      for (int i = 0; i < 3; ++i) ch[i] = o[i] = res[i];
    }
    __syncthreads();
  }
}

// ---- the cluster kernel -------------------------------------------------

constexpr int NG_SMEM_MAX = 232448;  // the opt-in limit of one block
constexpr int NG_GC_MAX = 8;         // streams a cluster serves, at most
constexpr int NG_PB = 16;            // pitches of one staged chunk of x
constexpr int NG_THREADS = 384;      // threads a block, at most

struct NgPlan { int C, Gc, clusters, smem; };

__host__ __device__ inline int ng_pad4(int g) { return (g + 3) & ~3; }

// Dynamic shared memory of one block, in bytes: W0f's column slice in the
// prologue, then U0, W1, U1's ([max(3H, F)][COLS]); W0c's columns [3][COLS];
// the heads' weights [3][H]; acc_F [N][Gp][COLS]; h0 and h1, two buffers
// each [2][2][H][Gp], with z and h1 U1 [2][Gp][COLS], which in the
// prologue hold two staged chunks of x [2][NG_PB][F] instead; chosen notes
// and head outputs [2][Gp][4].  Gp: the streams padded to a multiple of 4.
inline long long ng_smem_bytes(int C, int Gc, int N, int F, int H) {
  const long long COLS = 4 * (H / C), Gp = ng_pad4(Gc);
  const long long KW = std::max(3 * H, F);
  const long long hz =
      std::max(4LL * H * Gp + 2 * Gp * COLS, 2LL * NG_PB * F);
  return 4 * (KW * COLS + 3 * COLS + 3LL * H + (long long)N * Gp * COLS +
              hz + 8 * Gp);
}

// The work warps (one cell thread per unit and stream; one product
// thread per two gate columns and four streams), the rec warps (h1 U1, a
// product thread each) and three head warps.
inline int ng_threads(int C, int Gc, int H) {
  const int p0 = (H / C) * ng_pad4(Gc);
  return 32 * ((p0 + 31) / 32 + (p0 / 2 + 31) / 32 + 3);
}

// C from {8, 4, 16} dividing H, the first for which some Gc fits; Gc the
// most streams that fit (at most NG_GC_MAX and G), then spread evenly over
// the ceil(G / Gc) clusters.  False for widths that fit no plan.
inline bool ng_plan(int G, int N, int F, int H, NgPlan* p) {
  if (G <= 0 || N <= 0 || F <= 0 || H <= 0 || F % 4 != 0) return false;
  for (int C : {8, 4, 16}) {
    if (H % C != 0) continue;
    int gmax = 0;
    for (int gc = 1; gc <= NG_GC_MAX && gc <= G; ++gc)
      if (ng_smem_bytes(C, gc, N, F, H) <= NG_SMEM_MAX &&
          ng_threads(C, gc, H) <= NG_THREADS)
        gmax = gc;
    if (gmax == 0) continue;
    p->C = C;
    p->clusters = (G + gmax - 1) / gmax;
    p->Gc = (G + p->clusters - 1) / p->clusters;
    p->smem = (int)ng_smem_bytes(C, p->Gc, N, F, H);
    return true;
  }
  return false;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// GP: the cluster's streams padded to a multiple of 4 (4 or 8), so that
// the loops over streams and the h strides are fixed at compile time.
template <int GP>
__global__ void __launch_bounds__(NG_THREADS, 1) notegen_cluster_kernel(
    const float* __restrict__ feats, const float* __restrict__ uniforms,
    const float* __restrict__ temp, const float* __restrict__ w0f,
    const float* __restrict__ w0c, const float* __restrict__ a0,
    const float* __restrict__ u0, const float* __restrict__ w1,
    const float* __restrict__ a1, const float* __restrict__ u1,
    const float* __restrict__ wnd, const float* __restrict__ bnd,
    const float* __restrict__ wvd, const float* __restrict__ bvd,
    const float* __restrict__ vgrid, float* __restrict__ out, int G, int N,
    int F, int H, int hard, int max_velocity, NgPlan P,
    unsigned long long* prof) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned long long kstart = clock64();
  extern __shared__ __align__(16) float sm[];
  const int C = P.C, q = (int)cluster.block_rank();
  constexpr int Gp = GP;
  const int UJ = H / C, COLS = 4 * UJ, H4 = 4 * H;
  const int KW = max(3 * H, F);
  const int g0 = (blockIdx.x / C) * P.Gc, ng = min(P.Gc, G - g0);
  const int j0 = q * UJ;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* wr = sm;                          // [KW][COLS]
  float* w0cs = wr + (size_t)KW * COLS;    // [3][COLS]
  float* hw = w0cs + 3 * COLS;             // [3][H]
  float* accF = hw + 3 * H;                // [N][Gp][COLS]
  float* hb0 = accF + (size_t)N * Gp * COLS;  // [2][H][Gp]
  float* hb1 = hb0 + 2 * H * Gp;           // [2][H][Gp]
  float* zs = hb1 + 2 * H * Gp;            // [Gp][COLS]
  float* zr = zs + Gp * COLS;              // [Gp][COLS]
  float* xb = hb0;                         // prologue: [2][NG_PB][F]
  float* ch = hb0 + max(4 * H * Gp + 2 * Gp * COLS, 2 * NG_PB * F);
  float* hd = ch + 4 * Gp;                 // [Gp][4]
  // Local column lc: gate lc / UJ of unit j0 + lc % UJ.
  auto col = [&](int lc) { return (lc / UJ) * H + j0 + lc % UJ; };

  // Copies rows [0, K) of this block's columns of a [K][4H] matrix into
  // dst [K][COLS] with cp.async: 16 bytes at a time where a gate's UJ
  // columns split into aligned float4s, else 4.
  auto gather = [&](float* dst, const float* src, int K) {
    if (UJ % 4 == 0) {
      const int V = COLS / 4;
      for (int i = tid; i < K * V; i += nt) {
        const int k = i / V, lc = 4 * (i - k * V);
        cp_async16(dst + k * COLS + lc, src + (size_t)k * H4 + col(lc));
      }
    } else {
      for (int i = tid; i < K * COLS; i += nt) {
        const int k = i / COLS, lc = i - k * COLS;
        cp_async4(dst + i, src + (size_t)k * H4 + col(lc));
      }
    }
  };

  // -- prologue: acc_F = feat W0f for every pitch, for this block's columns.
  // W0f's column slice and x arrive by cp.async; x in chunks (stream s,
  // NG_PB pitches), two buffers, the next chunk in flight while this one
  // is multiplied.
  gather(wr, w0f, F);
  for (int i = tid; i < N * (Gp - ng) * COLS; i += nt) {
    const int r = i / COLS, lc = i - r * COLS;
    const int n = r / (Gp - ng), s = ng + r % (Gp - ng);
    accF[((size_t)n * Gp + s) * COLS + lc] = 0.f;
  }
  const int NCH = (N + NG_PB - 1) / NG_PB, nch = ng * NCH;
  const unsigned long long kgath = clock64();
  auto stage = [&](int c) {
    const int n0 = (c % NCH) * NG_PB, np = min(NG_PB, N - n0);
    const float* src = feats + ((size_t)(g0 + c / NCH) * N + n0) * F;
    float* dst = xb + (c & 1) * NG_PB * F;
    for (int i = 4 * tid; i < np * F; i += 4 * nt)
      cp_async16(dst + i, src + i);
    cp_commit();
  };
  stage(0);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      stage(c + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int s = c / NCH, n0 = (c % NCH) * NG_PB;
    const int np = min(NG_PB, N - n0);
    const float* x = xb + (c & 1) * NG_PB * F;
    // Item (columns lc, lc + 1; pitches p0, p0 + 1): four independent
    // chains over k; x read as float4s along k (a broadcast for the warp),
    // the weights as float2s.  Rows past np hold another chunk's x: their
    // chains run unguarded (a branch would stall every load) and are not
    // stored.
    for (int it = tid; it < (COLS / 2) * (NG_PB / 2); it += nt) {
      const int lc = 2 * (it % (COLS / 2)), p0 = (it / (COLS / 2)) * 2;
      if (p0 >= np) continue;
      float acc[2][2] = {};
#pragma unroll 4
      for (int k = 0; k < F; k += 4) {
        float2 w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = *reinterpret_cast<const float2*>(wr + (k + j) * COLS + lc);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float4 v =
              *reinterpret_cast<const float4*>(x + (p0 + p) * F + k);
          acc[p][0] = fmaf(v.x, w[0].x, acc[p][0]);
          acc[p][1] = fmaf(v.x, w[0].y, acc[p][1]);
          acc[p][0] = fmaf(v.y, w[1].x, acc[p][0]);
          acc[p][1] = fmaf(v.y, w[1].y, acc[p][1]);
          acc[p][0] = fmaf(v.z, w[2].x, acc[p][0]);
          acc[p][1] = fmaf(v.z, w[2].y, acc[p][1]);
          acc[p][0] = fmaf(v.w, w[3].x, acc[p][0]);
          acc[p][1] = fmaf(v.w, w[3].y, acc[p][1]);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (p0 + p < np)
          *reinterpret_cast<float2*>(
              accF + ((size_t)(n0 + p0 + p) * Gp + s) * COLS + lc) =
              make_float2(acc[p][0], acc[p][1]);
    }
    __syncthreads();
  }
  const unsigned long long kacc = clock64();
  // The carrying weights' columns, resident from here on: [3][H][COLS].
  gather(wr, u0, H);
  gather(wr + H * COLS, w1, H);
  gather(wr + 2 * H * COLS, u1, H);
  cp_commit();
  for (int i = tid; i < 3 * COLS; i += nt)
    w0cs[i] = w0c[(size_t)(i / COLS) * H4 + col(i % COLS)];
  for (int k = tid; k < H; k += nt) {
    hw[k] = wnd[2 * k];
    hw[H + k] = wnd[2 * k + 1];
    hw[2 * H + k] = wvd[k];
  }
  for (int i = tid; i < 4 * H * Gp; i += nt) hb0[i] = 0.f;  // hb0, hb1
  for (int i = tid; i < 4 * Gp; i += nt) ch[i] = 0.f;
  cp_wait<0>();
  // Roles by warp: WW work warps (cell thread tid < P0: unit gj, stream
  // gs, four neighbouring lanes holding four streams of one unit, which
  // one of them writes to every peer as a float4; product thread tid < P1:
  // columns plc, plc + 1 and streams 4 grp .. 4 grp + 3), WR rec warps
  // (the same product items for h1 U1), and three head warps (head w for
  // every stream, then the draw on lane s of the first).
  const int P0 = UJ * Gp, P1 = P0 / 2;
  const int WW = (P0 + 31) / 32, WR = (P1 + 31) / 32;
  const int role = warp < WW ? 0 : (warp < WW + WR ? 1 : 2);
  const int pt = role == 1 ? tid - 32 * WW : tid;  // product item
  const bool prod = role < 2 && pt < P1, cellt = role == 0 && tid < P0;
  const int plc = 2 * (pt % (COLS / 2)), grp = pt / (COLS / 2);
  const int gs = tid % Gp, gj = tid / Gp;
  const int hwarp = warp - WW - WR, dt = tid - 32 * (WW + WR);  // heads
  float a0r[4][2], a1r[4][2];  // the style terms of a product's items
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * grp + i;
    const bool v = role == 0 && prod && s < ng;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      a0r[i][e] = v ? a0[(size_t)(g0 + s) * H4 + col(plc + e)] : 0.f;
      a1r[i][e] = v ? a1[(size_t)(g0 + s) * H4 + col(plc + e)] : 0.f;
    }
  }
  float c0 = 0.f, c1 = 0.f;
  // acc[i][e] = the fmaf chain over k of h[k][4 grp + i] w[k][plc + e], for
  // h one [H][Gp] buffer and w one [H][COLS] weight slice.
  auto chain = [&](float (&acc)[4][2], const float* h, const float* w) {
    h += 4 * grp;
    w += plc;
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float2 wv = *reinterpret_cast<const float2*>(w + k * COLS);
      const float4 hv = *reinterpret_cast<const float4*>(h + k * Gp);
      acc[0][0] = fmaf(hv.x, wv.x, acc[0][0]);
      acc[0][1] = fmaf(hv.x, wv.y, acc[0][1]);
      acc[1][0] = fmaf(hv.y, wv.x, acc[1][0]);
      acc[1][1] = fmaf(hv.y, wv.y, acc[1][1]);
      acc[2][0] = fmaf(hv.z, wv.x, acc[2][0]);
      acc[2][1] = fmaf(hv.z, wv.y, acc[2][1]);
      acc[3][0] = fmaf(hv.w, wv.x, acc[3][0]);
      acc[3][1] = fmaf(hv.w, wv.y, acc[3][1]);
    }
  };
  // Work warps only: the four lanes of a unit gathered into one float4,
  // written to the same place in every block of the cluster.
  auto push = [&](float hv, float* buf) {
    const float v1 = __shfl_down_sync(0xffffffffu, hv, 1);
    const float v2 = __shfl_down_sync(0xffffffffu, hv, 2);
    const float v3 = __shfl_down_sync(0xffffffffu, hv, 3);
    if (cellt && (gs & 3) == 0) {
      const float4 v = make_float4(hv, v1, v2, v3);
      const int off = (j0 + gj) * Gp + gs;
      for (int r = 0; r < C; ++r)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(buf, r) + off) =
            v;
    }
  };
  // Named barriers: 1 work and head warps (the chosen notes), 2 work warps
  // (z between the products and the cells), 3 head warps (the heads).
  auto bar = [](int id, int warps) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(32 * warps) : "memory");
  };
  // The head warps: heads of pitch m from the full h1 (lane-strided over
  // k, reduced across the warp), then the draws of pitch m.
  const float hbias = hwarp == 0 ? bnd[0] : (hwarp == 1 ? bnd[1] : bvd[0]);
  const bool drawer = role == 2 && dt < ng;
  const float T = drawer ? temp[g0 + dt] : 1.f;
  auto heads_draw = [&](int m) {
    float ua = 0.f, ub = 0.f;  // the draw's uniforms, loaded first
    if (drawer) {
      const float* u = uniforms + ((size_t)(g0 + dt) * N + m) * 2;
      ua = u[0];
      ub = u[1];
    }
    const float* hp = hb1 + (m & 1) * H * Gp;
    const float* wv = hw + hwarp * H;
    float sum[Gp];
#pragma unroll
    for (int s = 0; s < Gp; ++s) sum[s] = 0.f;
    for (int k = lane; k < H; k += 32) {
      const float w = wv[k];
#pragma unroll
      for (int s = 0; s < Gp; s += 4) {
        const float4 h = *reinterpret_cast<const float4*>(hp + k * Gp + s);
        sum[s] = fmaf(h.x, w, sum[s]);
        sum[s + 1] = fmaf(h.y, w, sum[s + 1]);
        sum[s + 2] = fmaf(h.z, w, sum[s + 2]);
        sum[s + 3] = fmaf(h.w, w, sum[s + 3]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int s = 0; s < Gp; ++s)
        sum[s] += __shfl_xor_sync(0xffffffffu, sum[s], off);
    if (lane == 0)
#pragma unroll
      for (int s = 0; s < Gp; ++s)
        hd[4 * s + hwarp] = __fadd_rn(sum[s], hbias);
    bar(3, 3);
    if (drawer) {
      const int g = g0 + dt;
      float res[3];
      draw_note(hd + 4 * dt, T, ua, ub, vgrid, max_velocity, res);
      for (int i = 0; i < 3; ++i) ch[4 * dt + i] = res[i];
      if (q == 0) {
        float* o = out + ((size_t)g * N + m) * 3;
        for (int i = 0; i < 3; ++i) o[i] = res[i];
      }
    }
  };
  // prof (block 0): thread 0's clock cycles summed over the pitches of the
  // h0 U0 product; the wait for the draw with z0 and the cells; the h0
  // exchange and barrier 1; layer 1's product and cells; the h1 exchange
  // and barrier 2; the first head thread's heads and draw; then thread 0's
  // prologue and whole-kernel cycles, the plan and N, and the prologue's
  // cycles up to the acc_F chunks and in them.
  const bool timed = prof != nullptr && blockIdx.x == 0;
  const bool timed0 = timed && tid == 0;
  const bool timedh = timed && role == 2 && dt == 0;
  unsigned long long ck[6] = {0, 0, 0, 0, 0, 0}, ckh = 0, t0 = 0, t1 = 0;
  cluster.sync();
  if (timed0) ck[5] = clock64() - kstart;
  const unsigned long long lstart = timed0 ? clock64() : 0;

  for (int n = 0; n < N; ++n) {
    const int cur = (n + 1) & 1, nw = n & 1;  // read h of n - 1, write n
    if (role == 0) {
      // Layer 0: z0 = ((acc_F + chosen W0c) + a0) + h0 U0; the h0 U0
      // chain runs while the head warps draw pitch n - 1.
      if (timed0) t0 = clock64();
      float r[4][2] = {};
      if (prod) chain(r, hb0 + cur * H * Gp, wr);
      if (timed0) {
        t1 = clock64();
        ck[0] += t1 - t0;
      }
      bar(1, WW + 3);
      if (prod) {
        const float* ap = accF + ((size_t)n * Gp + 4 * grp) * COLS + plc;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* cs = ch + 4 * (4 * grp + i);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = plc + e;
            float zc = __fmul_rn(cs[0], w0cs[c]);
            zc = fmaf(cs[1], w0cs[COLS + c], zc);
            zc = fmaf(cs[2], w0cs[2 * COLS + c], zc);
            zs[(4 * grp + i) * COLS + c] = __fadd_rn(
                __fadd_rn(__fadd_rn(ap[i * COLS + e], zc), a0r[i][e]),
                r[i][e]);
          }
        }
      }
      bar(2, WW);
      float hv = 0.f;
      if (cellt) {
        const float* z = zs + gs * COLS + gj;
        hv = cell_f(z[0], z[UJ], z[2 * UJ], z[3 * UJ], &c0, hard);
      }
      if (timed0) {
        t0 = clock64();
        ck[1] += t0 - t1;
      }
      push(hv, hb0 + nw * H * Gp);
    } else if (role == 1) {
      // h1 U1 of layer 1, from h1 of pitch n - 1, into zr.
      if (prod) {
        float r[4][2] = {};
        chain(r, hb1 + cur * H * Gp, wr + 2 * H * COLS);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float2*>(zr + (4 * grp + i) * COLS + plc) =
              make_float2(r[i][0], r[i][1]);
      }
    } else {
      if (timedh) t0 = clock64();
      if (n > 0) heads_draw(n - 1);
      if (timedh) ckh += clock64() - t0;
      bar(1, WW + 3);
    }
    cluster.sync();
    if (timed0) {
      t1 = clock64();
      ck[2] += t1 - t0;
    }
    if (role == 0) {
      // Layer 1: z1 = (h0 W1 + a1) + h1 U1.
      float hv = 0.f;
      if (prod) {
        float a[4][2] = {};
        chain(a, hb0 + nw * H * Gp, wr + H * COLS);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = (4 * grp + i) * COLS + plc + e;
            zs[o] = __fadd_rn(__fadd_rn(a[i][e], a1r[i][e]), zr[o]);
          }
      }
      bar(2, WW);
      if (cellt) {
        const float* z = zs + gs * COLS + gj;
        hv = cell_f(z[0], z[UJ], z[2 * UJ], z[3 * UJ], &c1, hard);
      }
      if (timed0) {
        t0 = clock64();
        ck[3] += t0 - t1;
      }
      push(hv, hb1 + nw * H * Gp);
    }
    cluster.sync();
    if (timed0) ck[4] += clock64() - t0;
  }
  if (role == 2) heads_draw(N - 1);
  if (timedh) prof[5] = ckh;
  if (timed0) {
    prof[0] = ck[0];
    prof[1] = ck[1];
    prof[2] = ck[2];
    prof[3] = ck[3];
    prof[4] = ck[4];
    prof[6] = ck[5];
    prof[7] = clock64() - lstart + ck[5];
    prof[8] = C;
    prof[9] = P.Gc;
    prof[10] = P.clusters;
    prof[11] = N;
    prof[12] = kgath - kstart;
    prof[13] = kacc - kgath;
  }
}

// The cluster kernel's attributes, set once per process: the opt-in shared
// memory limit, and clusters of 16 (beyond the portable 8).
template <int GP>
cudaError_t ng_attributes() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        notegen_cluster_kernel<GP>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(notegen_cluster_kernel<GP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               NG_SMEM_MAX);
    return e;
  }();
  return err;
}

cudaLaunchConfig_t ng_config(const NgPlan& p, int H,
                             cudaLaunchAttribute* attr, cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C * p.clusters);
  cfg.blockDim = dim3(ng_threads(p.C, p.Gc, H));
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int GP>
int ng_launch(const float* feats, const float* uniforms, const float* temp,
              const float* w0f, const float* w0c, const float* a0,
              const float* u0, const float* w1, const float* a1,
              const float* u1, const float* wnd, const float* bnd,
              const float* wvd, const float* bvd, const float* vgrid,
              float* out, int G, int N, int F, int H, int hard,
              int max_velocity, const NgPlan& p, unsigned long long* prof,
              cudaStream_t st) {
  cudaError_t err = ng_attributes<GP>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ng_config(p, H, &attr, st);
  err = cudaLaunchKernelEx(&cfg, notegen_cluster_kernel<GP>, feats, uniforms,
                           temp, w0f, w0c, a0, u0, w1, a1, u1, wnd, bnd, wvd,
                           bvd, vgrid, out, G, N, F, H, hard, max_velocity, p,
                           prof);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int GP>
int ng_active(const NgPlan& p, int H, int* active) {
  const cudaError_t err = ng_attributes<GP>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ng_config(p, H, &attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(
      active, notegen_cluster_kernel<GP>, &cfg);
}

}  // namespace

// Plain C entries for ctypes.  Every pointer is a float32 CUDA buffer the
// caller allocated (contiguous, row-major, shapes as in the kernels);
// `vgrid` may be null (no quantization).  Each launches on `stream` and
// returns cudaGetLastError(): 0 when the launch was accepted.

// The cluster kernel, with the plan (C, Gc, clusters, smem) of
// ops/notegen.py::notegen_plan: cudaErrorInvalidValue when it is not
// ng_plan's, or the widths fit no plan.  `feats`, `w0f`, `u0`, `w1` and
// `u1` must be 16-byte aligned (cp.async).
// `prof` may be null; else 14 int64 on the card (see the kernel).
extern "C" int notegen_launch(
    const float* feats, const float* uniforms, const float* temp,
    const float* w0f, const float* w0c, const float* a0, const float* u0,
    const float* w1, const float* a1, const float* u1, const float* wnd,
    const float* bnd, const float* wvd, const float* bvd,
    const float* vgrid, float* out, int G, int N, int F, int H, int hard,
    int max_velocity, int C, int Gc, int clusters, int smem,
    unsigned long long* prof, void* stream) {
  NgPlan p;
  if (!ng_plan(G, N, F, H, &p) || p.C != C || p.Gc != Gc ||
      p.clusters != clusters || p.smem != smem)
    return (int)cudaErrorInvalidValue;
  for (const float* t : {feats, w0f, u0, w1, u1})
    if (reinterpret_cast<uintptr_t>(t) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (ng_pad4(p.Gc) == 4 ? ng_launch<4> : ng_launch<8>)(
      feats, uniforms, temp, w0f, w0c, a0, u0, w1, a1, u1, wnd, bnd, wvd,
      bvd, vgrid, out, G, N, F, H, hard, max_velocity, p, prof, st);
}

// The clusters of the plan for (G, N, F, H) that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *active.
extern "C" int notegen_active_clusters(int G, int N, int F, int H,
                                       int* active) {
  NgPlan p;
  if (!ng_plan(G, N, F, H, &p)) return (int)cudaErrorInvalidValue;
  return ng_pad4(p.Gc) == 4 ? ng_active<4>(p, H, active)
                            : ng_active<8>(p, H, active);
}

// The streamed kernel: one block per stream.
extern "C" int notegen_streamed_launch(
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
        notegen_streamed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // One thread per gate column, at least 3 warps (one per head), at most
  // 1024 (the loops over j stride by the block size).
  int threads = 4 * H < 96 ? 96 : (4 * H + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  notegen_streamed_kernel<<<G, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      feats, uniforms, temp, w0f, w0c, a0, u0, w1, a1, u1, wnd, bnd, wvd,
      bvd, vgrid, out, N, F, H, hard, max_velocity);
  return (int)cudaGetLastError();
}
