// The generation pitch loop as one CUDA kernel for Hopper (sm_90a).
//
// Replaces music_generator_tpu/ops/pallas_notegen.py::pallas_note_sample
// (the Pallas kernel `_make_kernel`, launched by `pl.pallas_call` in
// `_build.run`), and at note-axis depths other than 2 the scan of
// `DeepJ.note_axis_cell` that the JAX `Sampler._note_scan` runs there.
// One launch samples all N = 48 pitches of one generation timestep for G
// streams: per pitch, L note-axis LSTM cells (L = 1..8), the sigmoid
// play/replay and linear volume heads, clip -> logit -> / T -> sigmoid,
// the `u <= p` Bernoulli draws, replay * play, clip(volume) * play, and the
// optional snap of the volume onto the k/127 velocity grid
// (gen_volume_quantize).  The chosen note n feeds pitch n + 1.
//
// The math is the Pallas kernel's, in float32: W0 split into its feature
// rows W0f [F, 4H] and chosen rows W0c [3, 4H]; the style terms folded by
// the wrapper into a_l = tanh(s Ws_l + bs_l) W_l + b_l for every layer;
// z_0 = (feat W0f + chosen W0c + a_0) + h_0 U_0 and, for l >= 1, z_l =
// (h_{l-1} W_l + a_l) + h_l U_l; the heads read h_{L-1}; sigmoid as
// 1/(1+expf(-x)) (lax.logistic); temperature by true division; draws fire
// on u <= p.  Elementwise products and sums are written with
// __fmul_rn/__fadd_rn so that the compiler does not contract them into
// FMAs the plain PyTorch version does not use.  Built without
// --use_fast_math.  The layers' a_l, U_l and W_l arrive as a table of
// pointers (NgLayers), so the wrapper copies no weight per call.
//
// Two kernels compute this, bit for bit alike: every element of z is the
// same chain of fmaf in k order, associated as ((acc_F + zc) + a_0) + rec
// and (acc + a_l) + rec, and the cells, heads and draws share their code.
//
// What bounds it on this card.  The work per launch is about G * 2 * 48 *
// (F*4H + 3*4H + (2L-1)*H*4H + 3*H) FLOP (31.6 MFLOP a stream at F = 256,
// H = 128, L = 2; 12.6 more for each further layer) and about 0.5 + 0.25
// (2L - 1) MB of float32 weights: at G = 3 and L = 2 some 1.4 us of
// float32 FMA at the H100's 67 TFLOP/s and 0.4 us of HBM at 3.35 TB/s.
// Neither is the floor: the 48 pitches form a chain of dependent steps,
// each step a chain of L layers, and each needs the recurrent weights.
//
// notegen_cluster_kernel, the one the wrapper launches where its plan fits.
// Only h_0 U_0, the h_l U_l, chosen W0c and the h_{l-1} W_l carry from
// pitch to pitch; feat W0f does not.  So (1) a prologue in the same launch
// computes acc_F = feat W0f for every pitch and stream of the cluster,
// each block for its own gate columns, with its W0f column slice and x
// staged in shared memory by cp.async, and keeps acc_F in shared memory;
// (2) the carrying weights (U_0, then W_l and U_l of each further layer:
// (2L - 1) * 256 KB at H = 128) stay resident in the shared memory of a
// thread-block cluster of C blocks: block q owns the units [q H/C,
// (q+1) H/C) and the 4 H/C gate columns {a H + j} of them, so its gate
// sums land in its own shared memory and only h crosses blocks.  A cluster
// serves Gc streams.  A block's warps have three roles: work warps (a
// product thread owns two columns and four streams, so each weight read
// serves eight chains, or in the bfloat16 instances one column, so that
// every work warp takes a share; a cell thread one unit and stream), rec
// warps (the h_l U_l, which depend only on the previous pitch; two
// columns an item) and three head warps.
// Per pitch, phase 0: h_0 U_0 and h_1 U_1 while the head warps compute
// the heads and draws of the previous pitch from the full h_{L-1} (every
// block itself, 3 H MACs a stream, so the chosen note needs no exchange;
// block 0 writes the output); then z_0 with the chosen note, the cells of
// the block's units, its slice of h_0 written to every peer through
// distributed shared memory, a cluster barrier.  Phase l = 1..L-1: h_{l-1}
// W_l from the full h_{l-1} plus a_l and h_l U_l, the cells, its slice of
// h_l to every peer, a cluster barrier; the rec warps meanwhile compute
// h_{l+1} U_{l+1} of the previous pitch, into the other of two buffers.
// So a pitch costs L barriers.  h_0 and h_{L-1} alternate between two
// buffers by pitch (h_0 U_0 of the next pitch reads h_0 while peers write
// it; the heads read h_{L-1} in phase 0); a middle layer's h is written in
// its own phase only, after a barrier that every reader of the last
// pitch's value has passed, so it has one buffer.  The kernel is built for
// depth 2 with the layer loop fixed at compile time and for any depth with
// a run-time loop.  The plan (C, Gc, clusters, shared bytes) is `ng_plan`,
// mirrored by ops/notegen.py::notegen_plan; the launch refuses a plan that
// disagrees with it.
//
// notegen_streamed_kernel: one block per stream, thread j owns gate column
// j and streams all the weights from L2 at every pitch; its time is the
// latency of that chain of L2 reads.  The plan takes it at the depths whose
// resident weights overflow every cluster (6-8 at the flagship widths);
// elsewhere it holds the cluster kernel to bit for bit and is timed
// against it.
//
// Both kernels have bfloat16 instances (template parameter FL), for
// generation at gen_dtype="bfloat16", in the two arithmetics of the JAX
// Sampler's routes (ops/notegen.py's docstring has them and their rounding
// points).  Features and weights are stored in bfloat16 (half the shared
// memory a layer takes, so the plan, with 2-byte weights, keeps depths
// 6-8 in 16-block clusters), converted to float32 where they are read;
// every product and sum is float32, in the same fmaf chains and order as
// the float32 instance.  FL 2, the fused flavor (pallas_note_sample at
// compute_dtype=bfloat16): the float32 kernel with every dot's inputs
// rounded to bfloat16 (h, the chosen note).  FL 1, the scan flavor (the
// JAX scan of note_axis_cell): a layer's input is bf16(x + its style
// term) (layer 0's feature part formed by the wrapper, the chosen note's
// part and the further layers' from the style table `proj`); each
// product's sum and the two products' sum are rounded to bfloat16 and the
// bias added in float32 (z_scan); the heads' sums rounded, plus the
// rounded bias, rounded; the sigmoid of the heads as three rounded steps
// (sigmoid_bf16).
//
// Where h is rounded.  Every reader of an h in a bfloat16 instance takes
// a value that depends only on that h (and, for the scan flavor's input
// of layer l + 1, on the style term proj[g, l + 1, j], constant over the
// launch).  So the streamed kernel rounds at each read, and the cluster
// kernel rounds once, where the cell thread that owns (unit j, stream g)
// makes h and writes it to every block (`hstore`): the fused flavor
// writes bf16(h); the scan flavor writes bf16(h) for its last layer (read
// by h U and the heads), and for every other layer the pair bf16(h) (high
// half) and bf16(h + proj[g, l + 1, j]) (low half) in the 4 bytes of one
// float32 h, so the plan and the shared memory stay as they are.  Each
// product then reads a ready operand (`hget`: the float, or a half of the
// pair moved into a float32), and every fmaf takes the same operands in
// the same k order as when it rounded at the read: the two kernels stay
// bit for bit alike.  The float32 instance is unchanged: FL 0 makes each
// rounding an identity and writes h itself.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

// The instances: FL 0 the float32 kernels; FL 1 and 2 the bfloat16 ones,
// 1 the scan flavor and 2 the fused flavor (see the comment above).  The
// weights a kernel reads (W0f, W0c, U_l, W_l, the heads' kernels) and its
// features are of type NgW<FL>::T; everything else is float32.
template <int FL> struct NgW { using T = float; };
template <> struct NgW<1> { using T = __nv_bfloat16; };
template <> struct NgW<2> { using T = __nv_bfloat16; };

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// A dot's input: rounded to bfloat16 in both bfloat16 flavors.
template <int FL>
__device__ __forceinline__ float rin(float x) {
  return FL ? bf16r(x) : x;
}

// Loads of weight and feature elements as float32.
__device__ __forceinline__ float ldw(const float* p) { return *p; }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)*reinterpret_cast<const unsigned short*>(p)
                         << 16);
}
__device__ __forceinline__ float ldgw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldgw(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
// The two bfloat16 of a 4-byte word as float32, exactly: the low one
// (the lower address) shifted into the high half, the high one masked.
__device__ __forceinline__ float2 bf16x2_float2(unsigned v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}
// Two neighbouring elements (8- or 4-byte aligned).
__device__ __forceinline__ float2 ldw2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ldw2(const __nv_bfloat16* p) {
  return bf16x2_float2(*reinterpret_cast<const unsigned*>(p));
}
// Four neighbouring elements (16- or 8-byte aligned).
__device__ __forceinline__ float4 ldw4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ldw4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = bf16x2_float2(v.x), b = bf16x2_float2(v.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// The scan flavor's head sigmoid: 1 / (1 + exp(-s)) with each of the three
// steps rounded to bfloat16, as XLA on the CPU expands a bfloat16 logistic.
__device__ __forceinline__ float sigmoid_bf16(float s) {
  return bf16r(1.f / bf16r(__fadd_rn(1.f, bf16r(expf(-s)))));
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

// A head's output from its dot `sum` and bias: the scan flavor rounds the
// dot and the biased sum to bfloat16.
template <int FL>
__device__ __forceinline__ float head_out(float sum, float bias) {
  return FL == 1 ? bf16r(__fadd_rn(bf16r(sum), bias)) : __fadd_rn(sum, bias);
}

// The scan flavor's z of a layer from its input product xw (unrounded),
// recurrent product rec and bias b: bf16(bf16(xw) + bf16(rec)) + b, the
// last sum float32.
__device__ __forceinline__ float z_scan(float xw, float rec, float b) {
  return __fadd_rn(bf16r(__fadd_rn(bf16r(xw), bf16r(rec))), b);
}

// Temperature, draws and volume of one stream at one pitch from its head
// outputs hd[0..2] and uniforms (ua, ub): res = (play, replay * play,
// volume * play).
template <int FL>
__device__ __forceinline__ void draw_note(const float* hd, float T, float ua,
                                          float ub, const float* vgrid,
                                          int max_velocity, float* res) {
  float p[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    float q = FL == 1 ? sigmoid_bf16(hd[o]) : sigmoid_f(hd[o]);
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

// The chosen note's input k (0..2) to layer 0 of stream g: the note itself
// (float32), rounded (fused), or the scan flavor's bf16(c + its style
// term), c rounded first where the features are bfloat16 (`cround`).
template <int FL>
__device__ __forceinline__ float chosen_in(float c, float term, int cround) {
  if (FL != 1) return rin<FL>(c);
  return bf16r(__fadd_rn(cround ? bf16r(c) : c, term));
}

// The four-gate nonlinearity of z (i, f, g, o) into (h, c) in place.
__device__ __forceinline__ void lstm_gates(const float* z, float* h,
                                           float* c, int H, int hard,
                                           int tid, int nt) {
  for (int j = tid; j < H; j += nt)
    h[j] = cell_f(z[j], z[H + j], z[2 * H + j], z[3 * H + j], c + j, hard);
}

constexpr int NG_LMAX = 8;  // note-axis layers, at most

// The depth with cluster-kernel instances of its own (the layer loop fixed
// at compile time), for the float32 instance and both bfloat16 ones; every
// other depth runs the run-time loop.  A build with -DNG_FIXED_DEPTH=0
// runs every depth through the run-time loop: tools/notegen_depth_probe.py
// times the two at depth 2.
#ifndef NG_FIXED_DEPTH
#define NG_FIXED_DEPTH 2
#endif

// The per-layer operands: a[l] [G][4H] (the folded style terms, or the
// scan flavor's biases), u[l] [H][4H] (the recurrent weights) and, for
// l >= 1, w[l] [H][4H] (the input weights; w[0] is unused: layer 0's are
// W0f and W0c).
template <typename W>
struct NgLayers {
  const float* a[NG_LMAX];
  const W* u[NG_LMAX];
  const W* w[NG_LMAX];
};

// `proj` (the scan flavor only, else null): [G][L][H] float32, row 0 the
// style terms of the chosen note's three inputs to layer 0, row l >= 1
// those of layer l's input.
template <int FL>
__global__ void __launch_bounds__(1024) notegen_streamed_kernel(
    const typename NgW<FL>::T* __restrict__ feats,  // [G, N, F]
    const float* __restrict__ uniforms,             // [G, N, 2]
    const float* __restrict__ temp,                 // [G]
    const typename NgW<FL>::T* __restrict__ w0f,    // [F, 4H]
    const typename NgW<FL>::T* __restrict__ w0c,    // [3, 4H]
    const __grid_constant__ NgLayers<typename NgW<FL>::T> lw,
    const typename NgW<FL>::T* __restrict__ wnd,    // [H, 2]
    const float* __restrict__ bnd,                  // [2]
    const typename NgW<FL>::T* __restrict__ wvd,    // [H, 1]
    const float* __restrict__ bvd,                  // [1]
    const float* __restrict__ vgrid,  // [max_velocity + 1], or null
    const float* __restrict__ proj,   // [G, L, H], or null
    float* __restrict__ out,          // [G, N, 3]
    int N, int F, int H, int L, int hard, int max_velocity, int cround) {
  using W = typename NgW<FL>::T;
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  const int g = blockIdx.x;  // one block per stream
  const int tid = threadIdx.x;
  const int nt = blockDim.x;  // a multiple of 32, at least 3 warps
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // h_l = smem + 2 l H and c_l = h_l + H, [H] each, for l < L.
  float* z = smem + 2 * L * H;  // [4H]
  float* x = z + H4;            // [F]  this pitch's feature row
  float* ch = x + F;            // [4]  chosen (play, replay, volume)
  float* hd = ch + 4;           // [4]  head outputs
  const float* hl = smem + 2 * (L - 1) * H;  // the heads' input

  for (int i = tid; i < 2 * L * H; i += nt) smem[i] = 0.f;
  if (tid < 8) ch[tid] = 0.f;
  const float* a0 = lw.a[0] + (size_t)g * H4;
  const W* u0 = lw.u[0];
  const float* pg = FL == 1 ? proj + (size_t)g * L * H : nullptr;

  for (int n = 0; n < N; ++n) {
    const W* feat = feats + ((size_t)g * N + n) * F;
    for (int k = tid; k < F; k += nt) x[k] = ldw(feat + k);
    __syncthreads();

    // Layer 0: z0 = (feat W0f + chosen W0c + a0) + h0 U0.
    for (int j = tid; j < H4; j += nt) {
      float acc = 0.f, rec = 0.f;
#pragma unroll 8
      for (int k = 0; k < F; ++k)
        acc = fmaf(x[k], ldgw(w0f + (size_t)k * H4 + j), acc);
#pragma unroll 8
      for (int k = 0; k < H; ++k)
        rec = fmaf(rin<FL>(smem[k]), ldgw(u0 + (size_t)k * H4 + j), rec);
      float c3[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        c3[i] = chosen_in<FL>(ch[i], FL == 1 ? pg[i] : 0.f, cround);
      float zc = __fmul_rn(c3[0], ldw(w0c + j));
      zc = fmaf(c3[1], ldw(w0c + H4 + j), zc);
      zc = fmaf(c3[2], ldw(w0c + 2 * H4 + j), zc);
      z[j] = FL == 1 ? z_scan(__fadd_rn(acc, zc), rec, a0[j])
                     : __fadd_rn(__fadd_rn(__fadd_rn(acc, zc), a0[j]), rec);
    }
    __syncthreads();
    lstm_gates(z, smem, smem + H, H, hard, tid, nt);
    __syncthreads();

    // Layer l >= 1: z_l = (h_{l-1} W_l + a_l) + h_l U_l.
    for (int l = 1; l < L; ++l) {
      const float* hin = smem + 2 * (l - 1) * H;
      float* h = smem + 2 * l * H;
      const W* w = lw.w[l];
      const W* u = lw.u[l];
      const float* al = lw.a[l] + (size_t)g * H4;
      const float* pl = FL == 1 ? pg + (size_t)l * H : nullptr;
      for (int j = tid; j < H4; j += nt) {
        float acc = 0.f, rec = 0.f;
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float xk = FL == 1 ? bf16r(__fadd_rn(hin[k], __ldg(pl + k)))
                                   : rin<FL>(hin[k]);
          acc = fmaf(xk, ldgw(w + (size_t)k * H4 + j), acc);
          rec = fmaf(rin<FL>(h[k]), ldgw(u + (size_t)k * H4 + j), rec);
        }
        z[j] = FL == 1 ? z_scan(acc, rec, al[j])
                       : __fadd_rn(__fadd_rn(acc, al[j]), rec);
      }
      __syncthreads();
      lstm_gates(z, h, h + H, H, hard, tid, nt);
      __syncthreads();
    }

    // Heads: the (play, replay) logits and the linear volume, one warp
    // each, reduced across the warp.
    if (warp < 3) {
      float sum = 0.f;
      for (int k = lane; k < H; k += 32)
        sum = fmaf(rin<FL>(hl[k]), warp < 2 ? ldw(wnd + k * 2 + warp)
                                            : ldw(wvd + k), sum);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0)
        hd[warp] = head_out<FL>(sum, warp < 2 ? bnd[warp] : bvd[0]);
    }
    __syncthreads();

    // Temperature, draws and volume, on one thread.
    if (tid == 0) {
      const float* u = uniforms + ((size_t)g * N + n) * 2;
      float res[3];
      draw_note<FL>(hd, temp[g], u[0], u[1], vgrid, max_velocity, res);
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

// C == 0: no cluster, the streamed kernel (G blocks of one stream).
struct NgPlan { int C, Gc, clusters, smem; };

__host__ __device__ inline int ng_pad4(int g) { return (g + 3) & ~3; }

// The [H][Gp] buffers of h: two for h_0 and two for h_{L-1} (one pair at
// L = 1), one for each middle layer.
__host__ __device__ inline int ng_hbufs(int L) { return L == 1 ? 2 : L + 2; }
// The [Gp][COLS] buffers of z: the cells' z and one (L = 2) or two (L > 2)
// for the rec warps' h_l U_l; none at L = 1.
__host__ __device__ inline int ng_zbufs(int L) {
  return 1 + (L - 1 < 2 ? L - 1 : 2);
}
// The floats that the resident weights' [KW][COLS] elements of `esize`
// bytes take, padded to 16 bytes.
__host__ __device__ inline long long ng_wfloats(long long KW, long long COLS,
                                                int esize) {
  return (KW * COLS * esize + 15) / 16 * 4;
}
// The floats of the prologue's two staged chunks of x [2][NG_PB][F].
__host__ __device__ inline long long ng_xfloats(int F, int esize) {
  return (2LL * NG_PB * F * esize + 3) / 4;
}

// Dynamic shared memory of one block, in bytes: W0f's column slice in the
// prologue, then U_0 and the W_l, U_l of the further layers ([max((2L-1)H,
// F)][COLS] elements of `esize` bytes, padded to 16 bytes); in float32
// W0c's columns [3][COLS]; the heads' weights [3][H]; acc_F
// [N][Gp][COLS]; the h buffers [ng_hbufs(L)][H][Gp] with the z buffers
// [ng_zbufs(L)][Gp][COLS], which in the prologue hold two staged chunks of
// x [2][NG_PB][F] (elements of `esize` bytes) instead; chosen notes and
// head outputs [2][Gp][4].  Gp: the streams padded to a multiple of 4.
inline long long ng_smem_bytes(int C, int Gc, int L, int N, int F, int H,
                               int esize) {
  const long long COLS = 4 * (H / C), Gp = ng_pad4(Gc);
  const long long KW = std::max((2LL * L - 1) * H, (long long)F);
  const long long hz =
      std::max((long long)ng_hbufs(L) * H * Gp + ng_zbufs(L) * Gp * COLS,
               ng_xfloats(F, esize));
  return 4 * (ng_wfloats(KW, COLS, esize) + 3 * COLS + 3LL * H +
              (long long)N * Gp * COLS + hz + 8 * Gp);
}

// The work warps (one cell thread per unit and stream; one product
// thread per two gate columns and four streams), the rec warps (h_l U_l, a
// product thread each) and three head warps.
inline int ng_threads(int C, int Gc, int H) {
  const int p0 = (H / C) * ng_pad4(Gc);
  return 32 * ((p0 + 31) / 32 + (p0 / 2 + 31) / 32 + 3);
}

// The streamed kernel's block: [L][2][H] of h and c, z [4H], x [F], the
// chosen notes and head outputs; a thread per gate column, 96 to 1024.
inline long long ng_streamed_smem(int L, int F, int H) {
  return 4 * (2LL * L * H + 4LL * H + F + 8);
}
inline int ng_streamed_threads(int H) {
  const int t = 4 * H < 96 ? 96 : (4 * H + 31) / 32 * 32;
  return t > 1024 ? 1024 : t;
}

// The cluster plan at depth L: C from {8, 4, 16} dividing H, the first for
// which some Gc fits; Gc the most streams that fit (at most NG_GC_MAX and
// G), then spread evenly over the ceil(G / Gc) clusters.
inline bool ng_cluster_plan(int G, int L, int N, int F, int H, int esize,
                            NgPlan* p) {
  for (int C : {8, 4, 16}) {
    if (H % C != 0) continue;
    int gmax = 0;
    for (int gc = 1; gc <= NG_GC_MAX && gc <= G; ++gc)
      if (ng_smem_bytes(C, gc, L, N, F, H, esize) <= NG_SMEM_MAX &&
          ng_threads(C, gc, H) <= NG_THREADS)
        gmax = gc;
    if (gmax == 0) continue;
    p->C = C;
    p->clusters = (G + gmax - 1) / gmax;
    p->Gc = (G + p->clusters - 1) / p->clusters;
    p->smem = (int)ng_smem_bytes(C, p->Gc, L, N, F, H, esize);
    return true;
  }
  return false;
}

// The plan: the cluster kernel where a cluster holds the L layers' weights;
// else, at widths where a cluster serves one layer, the streamed kernel
// (C = 0, G blocks).  False where nothing fits.
inline bool ng_plan(int G, int L, int N, int F, int H, int esize,
                    NgPlan* p) {
  if (G <= 0 || N <= 0 || F <= 0 || H <= 0 || F % 4 != 0 || L < 1 ||
      L > NG_LMAX)
    return false;
  if (ng_cluster_plan(G, L, N, F, H, esize, p)) return true;
  NgPlan one;
  if (!ng_cluster_plan(G, 1, N, F, H, esize, &one) ||
      ng_streamed_smem(L, F, H) > NG_SMEM_MAX)
    return false;
  *p = NgPlan{0, 1, G, (int)ng_streamed_smem(L, F, H)};
  return true;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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

// How a product reads an element of an h buffer of the cluster kernel: the
// float32 as written (NG_H), or the high (NG_HI: bf16(h)) or low (NG_LO:
// bf16(h + its style term)) bfloat16 of the scan flavor's pair, moved
// into a float32 exactly.
enum { NG_H = 0, NG_HI = 1, NG_LO = 2 };
template <int RD>
__device__ __forceinline__ float hget(float v) {
  if (RD == NG_HI) return __uint_as_float(__float_as_uint(v) & 0xffff0000u);
  if (RD == NG_LO) return __uint_as_float(__float_as_uint(v) << 16);
  return v;
}

// acc[i][e] += the fmaf chain over k of hget<RD>(h[k][i]) w[k][e], for h
// four streams' columns of one [H][GP] buffer and w NC (1 or 2)
// neighbouring columns of one [H][COLS] weight slice.  The loop over k is
// unrolled 8 times for float32 weights and 16 times for bfloat16 ones,
// which hides more of the shared loads' latency in those instances.
template <int RD, int GP, int NC, typename W>
__device__ __forceinline__ void ng_chain(float (&acc)[4][NC], const float* h,
                                         const W* w, int H, int COLS) {
#pragma unroll(sizeof(W) == 2 ? 16 : 8)
  for (int k = 0; k < H; ++k) {
    float wv[NC];
    if (NC == 2) {
      const float2 v = ldw2(w + k * COLS);
      wv[0] = v.x;
      wv[NC - 1] = v.y;
    } else {
      wv[0] = ldw(w + k * COLS);
    }
    const float4 hr = *reinterpret_cast<const float4*>(h + k * GP);
    const float hv[4] = {hget<RD>(hr.x), hget<RD>(hr.y), hget<RD>(hr.z),
                         hget<RD>(hr.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < NC; ++e) acc[i][e] = fmaf(hv[i], wv[e], acc[i][e]);
  }
}

// GP: the cluster's streams padded to a multiple of 4 (4 or 8), so that
// the loops over streams and the h strides are fixed at compile time.
// LC: the depth fixed at compile time (2), or 0 for a run-time loop over
// the depth `Lrt` (the layer loop's c, the scan flavor's style terms and
// a_l then live in local and global memory instead of registers).  FL: the
// instance (see NgW).
template <int GP, int LC, int FL>
__global__ void __launch_bounds__(NG_THREADS, 1) notegen_cluster_kernel(
    const typename NgW<FL>::T* __restrict__ feats,
    const float* __restrict__ uniforms, const float* __restrict__ temp,
    const typename NgW<FL>::T* __restrict__ w0f,
    const typename NgW<FL>::T* __restrict__ w0c,
    const __grid_constant__ NgLayers<typename NgW<FL>::T> lw,
    const typename NgW<FL>::T* __restrict__ wnd,
    const float* __restrict__ bnd,
    const typename NgW<FL>::T* __restrict__ wvd,
    const float* __restrict__ bvd, const float* __restrict__ vgrid,
    const float* __restrict__ proj, float* __restrict__ out, int G, int N,
    int F, int H, int Lrt, int hard, int max_velocity, int cround, NgPlan P,
    unsigned long long* prof) {
  using W = typename NgW<FL>::T;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned long long kstart = clock64();
  extern __shared__ __align__(16) float sm[];
  const int L = LC ? LC : Lrt;
  const int C = P.C, q = (int)cluster.block_rank();
  constexpr int Gp = GP;
  const int UJ = H / C, COLS = 4 * UJ, H4 = 4 * H;
  const int KW = max((2 * L - 1) * H, F);
  const int HB = ng_hbufs(L);
  const int g0 = (blockIdx.x / C) * P.Gc, ng = min(P.Gc, G - g0);
  const int j0 = q * UJ;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  // wr: U_0 at row 0, W_l at row (2l - 1) H and U_l at row 2l H.
  W* wr = reinterpret_cast<W*>(sm);        // [KW][COLS]
  float* w0cs = sm + ng_wfloats(KW, COLS, sizeof(W));  // [3][COLS]
  float* hw = w0cs + 3 * COLS;             // [3][H]
  float* accF = hw + 3 * H;                // [N][Gp][COLS]
  float* hb = accF + (size_t)N * Gp * COLS;  // [HB][H][Gp]
  float* zs = hb + HB * H * Gp;            // [Gp][COLS]
  float* zr = zs + Gp * COLS;              // [2][Gp][COLS] (L > 2)
  W* xb = reinterpret_cast<W*>(hb);        // prologue: [2][NG_PB][F]
  float* ch = hb + max((long long)HB * H * Gp + ng_zbufs(L) * Gp * COLS,
                       ng_xfloats(F, sizeof(W)));
  float* hd = ch + 4 * Gp;                 // [Gp][4]
  // h_l of pitch parity par: buffers 0-1 h_0, 2-3 h_{L-1}, 4.. the middle.
  auto hbuf = [&](int l, int par) -> float* {
    if (l == 0) return hb + par * H * Gp;
    if (l == L - 1) return hb + (2 + par) * H * Gp;
    return hb + (3 + l) * H * Gp;
  };
  // Local column lc: gate lc / UJ of unit j0 + lc % UJ.
  auto col = [&](int lc) { return (lc / UJ) * H + j0 + lc % UJ; };

  // Copies rows [0, K) of this block's columns of a [K][4H] matrix into
  // dst [K][COLS]: with cp.async 16 bytes at a time where a gate's UJ
  // columns split into aligned 16-byte pieces, else 4 (float32) or one
  // element at a time by plain loads and stores (bfloat16).
  auto gather = [&](W* dst, const W* src, int K) {
    constexpr int V = 16 / sizeof(W);  // elements of 16 bytes
    if (UJ % V == 0) {
      const int NV = COLS / V;
      for (int i = tid; i < K * NV; i += nt) {
        const int k = i / NV, lc = V * (i - k * NV);
        cp_async16(dst + k * COLS + lc, src + (size_t)k * H4 + col(lc));
      }
    } else if (sizeof(W) == 4) {
      for (int i = tid; i < K * COLS; i += nt) {
        const int k = i / COLS, lc = i - k * COLS;
        cp_async4(dst + i, src + (size_t)k * H4 + col(lc));
      }
    } else {
      for (int i = tid; i < K * COLS; i += nt) {
        const int k = i / COLS, lc = i - k * COLS;
        dst[i] = src[(size_t)k * H4 + col(lc)];
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
    const W* src = feats + ((size_t)(g0 + c / NCH) * N + n0) * F;
    W* dst = xb + (c & 1) * NG_PB * F;
    for (int i = 4 * tid; i < np * F; i += 4 * nt) {
      if (sizeof(W) == 4)
        cp_async16(dst + i, src + i);
      else
        cp_async8(dst + i, src + i);
    }
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
    const W* x = xb + (c & 1) * NG_PB * F;
    // Item (columns lc, lc + 1; pitches p0, p0 + 1): four independent
    // chains over k; x read four elements at a time along k (a broadcast
    // for the warp), the weights two.  Rows past np hold another chunk's
    // x: their chains run unguarded (a branch would stall every load) and
    // are not stored.
    for (int it = tid; it < (COLS / 2) * (NG_PB / 2); it += nt) {
      const int lc = 2 * (it % (COLS / 2)), p0 = (it / (COLS / 2)) * 2;
      if (p0 >= np) continue;
      float acc[2][2] = {};
#pragma unroll 4
      for (int k = 0; k < F; k += 4) {
        float2 w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = ldw2(wr + (k + j) * COLS + lc);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float4 v = ldw4(x + (p0 + p) * F + k);
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
  // The carrying weights' columns, resident from here on.
  gather(wr, lw.u[0], H);
  for (int l = 1; l < L; ++l) {
    gather(wr + (2 * l - 1) * H * COLS, lw.w[l], H);
    gather(wr + 2 * l * H * COLS, lw.u[l], H);
  }
  cp_commit();
  for (int i = tid; i < 3 * COLS; i += nt)
    w0cs[i] = ldw(w0c + (size_t)(i / COLS) * H4 + col(i % COLS));
  for (int k = tid; k < H; k += nt) {
    hw[k] = ldw(wnd + 2 * k);
    hw[H + k] = ldw(wnd + 2 * k + 1);
    hw[2 * H + k] = ldw(wvd + k);
  }
  for (int i = tid; i < HB * H * Gp; i += nt) hb[i] = 0.f;
  for (int i = tid; i < 4 * Gp; i += nt) ch[i] = 0.f;
  cp_wait<0>();
  // Roles by warp: WW work warps (cell thread tid < P0: unit gj, stream
  // gs, four neighbouring lanes holding four streams of one unit, which
  // one of them writes to every peer as a float4; product thread: PC
  // columns plc .. plc + PC - 1 and streams 4 grp .. 4 grp + 3), WR rec
  // warps (product items of two columns for the h_l U_l), and three head
  // warps (head w for every stream, then the draw on lane s of the first).
  // PC: the float32 instance's work items have two columns (tid < P1, so
  // half the work warps wait out the products); the bfloat16 instances'
  // one (tid < P0), so every work warp takes products, each thread half
  // the fmaf of a k step, and each weight element is loaded and unpacked
  // as one.  The order of every fmaf chain is the same either way.
  constexpr int PC = FL ? 1 : 2;
  const int P0 = UJ * Gp, P1 = P0 / 2;
  const int WW = (P0 + 31) / 32, WR = (P1 + 31) / 32;
  const int role = warp < WW ? 0 : (warp < WW + WR ? 1 : 2);
  const int pt = role == 1 ? tid - 32 * WW : tid;  // product item
  const int npc = role == 0 ? PC : 2;  // the item's columns
  const bool prod = role < 2 && pt < (role == 0 ? P0 / PC : P1);
  const bool cellt = role == 0 && tid < P0;
  const int plc = npc * (pt % (COLS / npc)), grp = pt / (COLS / npc);
  const int gs = tid % Gp, gj = tid / Gp;
  const int hwarp = warp - WW - WR, dt = tid - 32 * (WW + WR);  // heads
  // The style terms of a product's items: a_0, and a_1 at depth 2; at
  // other depths a_l is read from global memory (L1) in its phase.
  // aoff: the items' offsets in an a_l, -1 for padded streams.
  float a0r[4][2], a1r[4][2];
  int aoff[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * grp + i;
    const bool v = role == 0 && prod && s < ng;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      aoff[i][e] = v && e < PC ? (g0 + s) * H4 + col(plc + e) : -1;
      a0r[i][e] = aoff[i][e] >= 0 ? lw.a[0][aoff[i][e]] : 0.f;
      a1r[i][e] = aoff[i][e] >= 0 && LC == 2 ? lw.a[1][aoff[i][e]] : 0.f;
    }
  }
  // The scan flavor's style terms of the chosen note's three inputs, for
  // the items' streams (a padded stream takes its cluster's last real one).
  float p0c[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* pj =
        FL == 1 ? proj + (size_t)(g0 + min(4 * grp + i, ng - 1)) * L * H
                : nullptr;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p0c[i][k] = FL == 1 && role == 0 && prod ? pj[k] : 0.f;
  }
  // Each cell thread's c, one a layer, and in the scan flavor the style
  // term that its h_l meets at the input of layer l + 1 (l < L - 1):
  // proj[g, l + 1, j] of its unit j and stream g (a padded stream, its
  // cluster's last real one), loaded once: it holds for every pitch.
  float cst[LC ? LC : NG_LMAX], pst[LC ? LC : NG_LMAX];
#pragma unroll
  for (int l = 0; l < (LC ? LC : NG_LMAX); ++l) {
    cst[l] = 0.f;
    pst[l] = FL == 1 && cellt && l + 1 < L
                 ? proj[((size_t)(g0 + min(gs, ng - 1)) * L + l + 1) * H +
                        j0 + gj]
                 : 0.f;
  }
  // What the cell thread writes of its h_l for every reader (see the
  // header): h (float32), bf16(h) (fused; the scan flavor's last layer),
  // or the scan flavor's pair, bf16(h) high and bf16(h + pst[l]) low.
  auto hstore = [&](float h, int l) -> float {
    if (FL == 0) return h;
    if (FL == 2 || l == L - 1) return bf16r(h);
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(h));
    const unsigned lo =
        __bfloat16_as_ushort(__float2bfloat16_rn(__fadd_rn(h, pst[l])));
    return __uint_as_float(hi << 16 | lo);
  };
  // acc[i][e] = the fmaf chain over k of h[k][4 grp + i] w[k][plc + e], for
  // h one [H][Gp] buffer, read as `rd` says (the scan flavor's pairs: NG_HI
  // for h_l U_l, NG_LO for the input of layer l + 1; else NG_H), and w one
  // [H][COLS] weight slice.
  auto chain = [&](auto& acc, const float* h, const W* w, int rd) {
    h += 4 * grp;
    w += plc;
    if (FL == 1 && rd == NG_HI)
      ng_chain<NG_HI, Gp>(acc, h, w, H, COLS);
    else if (FL == 1 && rd == NG_LO)
      ng_chain<NG_LO, Gp>(acc, h, w, H, COLS);
    else
      ng_chain<NG_H, Gp>(acc, h, w, H, COLS);
  };
  // How h_l U_l reads h_l: a pair in the scan flavor below the last layer.
  auto rd_rec = [&](int l) { return FL == 1 && l < L - 1 ? NG_HI : NG_H; };
  // The rec warps: h_l U_l of the previous pitch into z buffer zb.
  auto rec = [&](int l, int cur, float* zb) {
    if (!prod) return;
    float r[4][2] = {};
    chain(r, hbuf(l, cur), wr + 2 * l * H * COLS, rd_rec(l));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float2*>(zb + (4 * grp + i) * COLS + plc) =
          make_float2(r[i][0], r[i][1]);
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
  // The head warps: heads of pitch m from the full h_{L-1} (lane-strided
  // over k, reduced across the warp), then the draws of pitch m.
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
    const float* hp = hbuf(L - 1, m & 1);  // rounded where it was made
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
        hd[4 * s + hwarp] = head_out<FL>(sum[s], hbias);
    bar(3, 3);
    if (drawer) {
      const int g = g0 + dt;
      float res[3];
      draw_note<FL>(hd + 4 * dt, T, ua, ub, vgrid, max_velocity, res);
      for (int i = 0; i < 3; ++i) ch[4 * dt + i] = res[i];
      if (q == 0) {
        float* o = out + ((size_t)g * N + m) * 3;
        for (int i = 0; i < 3; ++i) o[i] = res[i];
      }
    }
  };
  // prof (block 0): thread 0's clock cycles summed over the pitches of the
  // h0 U0 product; the wait for the draw with z0 and the cells; the h0
  // exchange and the first barrier; the products and cells of the layers
  // l >= 1; their h exchanges and barriers; the first head thread's heads
  // and draw; then thread 0's prologue and whole-kernel cycles, the plan
  // and N, and the prologue's cycles up to the acc_F chunks and in them.
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
      float r[4][PC] = {};
      if (prod) chain(r, hbuf(0, cur), wr, rd_rec(0));
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
          float c3[3];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            c3[k] = chosen_in<FL>(cs[k], p0c[i][k], cround);
#pragma unroll
          for (int e = 0; e < PC; ++e) {
            const int c = plc + e;
            float zc = __fmul_rn(c3[0], w0cs[c]);
            zc = fmaf(c3[1], w0cs[COLS + c], zc);
            zc = fmaf(c3[2], w0cs[2 * COLS + c], zc);
            zs[(4 * grp + i) * COLS + c] =
                FL == 1
                    ? z_scan(__fadd_rn(ap[i * COLS + e], zc), r[i][e],
                             a0r[i][e])
                    : __fadd_rn(__fadd_rn(__fadd_rn(ap[i * COLS + e], zc),
                                          a0r[i][e]),
                                r[i][e]);
          }
        }
      }
      bar(2, WW);
      float hv = 0.f;
      if (cellt) {
        const float* z = zs + gs * COLS + gj;
        hv = cell_f(z[0], z[UJ], z[2 * UJ], z[3 * UJ], &cst[0], hard);
      }
      if (timed0) {
        t0 = clock64();
        ck[1] += t0 - t1;
      }
      push(hstore(hv, 0), hbuf(0, nw));
    } else if (role == 1) {
      // h_1 U_1 of layer 1, from h_1 of pitch n - 1.
      if (L > 1) rec(1, cur, zr);
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
    for (int l = 1; l < L; ++l) {
      if (role == 0) {
        // Layer l: z_l = (h_{l-1} W_l + a_l) + h_l U_l.
        const float* zrl = zr + ((l - 1) & 1) * Gp * COLS;
        const float* al = lw.a[l];
        float hv = 0.f;
        if (prod) {
          float a[4][PC] = {};
          chain(a, hbuf(l - 1, nw), wr + (2 * l - 1) * H * COLS, NG_LO);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < PC; ++e) {
              const int o = (4 * grp + i) * COLS + plc + e;
              const float ar =
                  LC == 2 ? a1r[i][e]
                          : (aoff[i][e] < 0 ? 0.f : __ldg(al + aoff[i][e]));
              zs[o] = FL == 1 ? z_scan(a[i][e], zrl[o], ar)
                              : __fadd_rn(__fadd_rn(a[i][e], ar), zrl[o]);
            }
        }
        bar(2, WW);
        if (cellt) {
          const float* z = zs + gs * COLS + gj;
          hv = cell_f(z[0], z[UJ], z[2 * UJ], z[3 * UJ], &cst[l], hard);
        }
        if (timed0) {
          t0 = clock64();
          ck[3] += t0 - t1;
        }
        push(hstore(hv, l), hbuf(l, nw));
      } else if (role == 1) {
        // h_{l+1} U_{l+1} of pitch n - 1, for the next phase.
        if (l + 1 < L) rec(l + 1, cur, zr + (l & 1) * Gp * COLS);
      }
      cluster.sync();
      if (timed0) {
        t1 = clock64();
        ck[4] += t1 - t0;
      }
    }
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

// The cluster kernel's attributes, set once per process and instance: the
// opt-in shared memory limit, and clusters of 16 (beyond the portable 8).
template <int GP, int LC, int FL>
cudaError_t ng_attributes() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        notegen_cluster_kernel<GP, LC, FL>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(notegen_cluster_kernel<GP, LC, FL>,
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

// One kernel's operands as the C entries receive them.
struct NgArgs {
  const void *feats, *w0f, *w0c, *wnd, *wvd;
  const float *uniforms, *temp, *bnd, *bvd, *vgrid, *proj;
  float* out;
  int G, N, F, H, L, hard, max_velocity, cround;
};

// The table of per-layer pointers from the C entries' flat array `layers`
// [3][NG_LMAX] (a, u, w); false if a pointer the depth needs is null or a
// weight is not 16-byte aligned (cp.async).
template <typename W>
bool ng_layers(const void* const* layers, int L, NgLayers<W>* lw) {
  for (int l = 0; l < NG_LMAX; ++l) {
    lw->a[l] = l < L ? static_cast<const float*>(layers[l]) : nullptr;
    lw->u[l] = l < L ? static_cast<const W*>(layers[NG_LMAX + l]) : nullptr;
    lw->w[l] = l >= 1 && l < L
                   ? static_cast<const W*>(layers[2 * NG_LMAX + l])
                   : nullptr;
    if (l >= L) continue;
    if (lw->a[l] == nullptr || lw->u[l] == nullptr ||
        reinterpret_cast<uintptr_t>(lw->u[l]) % 16 != 0)
      return false;
    if (l >= 1 && (lw->w[l] == nullptr ||
                   reinterpret_cast<uintptr_t>(lw->w[l]) % 16 != 0))
      return false;
  }
  return true;
}

// The instance for the plan's padded streams, the depth and the flavor.
template <int GP, int LC, int FL>
int ng_launch(const NgArgs& a, const NgLayers<typename NgW<FL>::T>& lw,
              const NgPlan& p, unsigned long long* prof, cudaStream_t st) {
  using W = typename NgW<FL>::T;
  cudaError_t err = ng_attributes<GP, LC, FL>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ng_config(p, a.H, &attr, st);
  err = cudaLaunchKernelEx(
      &cfg, notegen_cluster_kernel<GP, LC, FL>,
      static_cast<const W*>(a.feats), a.uniforms, a.temp,
      static_cast<const W*>(a.w0f), static_cast<const W*>(a.w0c), lw,
      static_cast<const W*>(a.wnd), a.bnd, static_cast<const W*>(a.wvd),
      a.bvd, a.vgrid, a.proj, a.out, a.G, a.N, a.F, a.H, a.L, a.hard,
      a.max_velocity, a.cround, p, prof);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int GP, int LC, int FL>
int ng_active(const NgPlan& p, int H, int* active) {
  const cudaError_t err = ng_attributes<GP, LC, FL>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ng_config(p, H, &attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(
      active, notegen_cluster_kernel<GP, LC, FL>, &cfg);
}

constexpr int ng_esize(int FL) { return FL ? 2 : 4; }

// The cluster kernel of flavor FL with the caller's plan, which must be
// ng_plan's.
template <int FL>
int ng_cluster(const NgArgs& a, const void* const* layers, const NgPlan& want,
               unsigned long long* prof, void* stream) {
  NgPlan p;
  if (!ng_plan(a.G, a.L, a.N, a.F, a.H, ng_esize(FL), &p) || p.C == 0 ||
      p.C != want.C || p.Gc != want.Gc || p.clusters != want.clusters ||
      p.smem != want.smem)
    return (int)cudaErrorInvalidValue;
  NgLayers<typename NgW<FL>::T> lw;
  if (!ng_layers(layers, a.L, &lw)) return (int)cudaErrorInvalidValue;
  for (const void* t : {a.feats, a.w0f})
    if (reinterpret_cast<uintptr_t>(t) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (FL == 1 && a.proj == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool four = ng_pad4(p.Gc) == 4;
  if (a.L == NG_FIXED_DEPTH)
    return four ? ng_launch<4, NG_FIXED_DEPTH, FL>(a, lw, p, prof, st)
                : ng_launch<8, NG_FIXED_DEPTH, FL>(a, lw, p, prof, st);
  return four ? ng_launch<4, 0, FL>(a, lw, p, prof, st)
              : ng_launch<8, 0, FL>(a, lw, p, prof, st);
}

template <int FL>
int ng_active_clusters(int G, int L, int N, int F, int H, int* active) {
  NgPlan p;
  if (!ng_plan(G, L, N, F, H, ng_esize(FL), &p) || p.C == 0)
    return (int)cudaErrorInvalidValue;
  const bool four = ng_pad4(p.Gc) == 4;
  if (L == NG_FIXED_DEPTH)
    return four ? ng_active<4, NG_FIXED_DEPTH, FL>(p, H, active)
                : ng_active<8, NG_FIXED_DEPTH, FL>(p, H, active);
  return four ? ng_active<4, 0, FL>(p, H, active)
              : ng_active<8, 0, FL>(p, H, active);
}

template <int FL>
int ng_streamed(const NgArgs& a, const void* const* layers, void* stream) {
  using W = typename NgW<FL>::T;
  if (a.G <= 0 || a.N <= 0 || a.F <= 0 || a.H <= 0 || a.L < 1 ||
      a.L > NG_LMAX)
    return (int)cudaErrorInvalidValue;
  NgLayers<W> lw;
  if (!ng_layers(layers, a.L, &lw)) return (int)cudaErrorInvalidValue;
  if (FL == 1 && a.proj == nullptr) return (int)cudaErrorInvalidValue;
  const long long smem = ng_streamed_smem(a.L, a.F, a.H);
  if (smem > NG_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        notegen_streamed_kernel<FL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // One thread per gate column, at least 3 warps (one per head), at most
  // 1024 (the loops over j stride by the block size).
  notegen_streamed_kernel<FL><<<a.G, ng_streamed_threads(a.H), (size_t)smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(a.feats), a.uniforms, a.temp,
      static_cast<const W*>(a.w0f), static_cast<const W*>(a.w0c), lw,
      static_cast<const W*>(a.wnd), a.bnd, static_cast<const W*>(a.wvd),
      a.bvd, a.vgrid, a.proj, a.out, a.N, a.F, a.H, a.L, a.hard,
      a.max_velocity, a.cround);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes.  Every pointer is a CUDA buffer the caller
// allocated (contiguous, row-major, shapes as in the kernels), float32 in
// the float32 entries; `vgrid` may be null (no quantization); `layers` is
// a host array of 3 * 8 pointers: a_0..a_7 [G][4H], U_0..U_7 [H][4H],
// W_0..W_7 [H][4H] (W_0 unused), those past the depth L unused.  Each
// launches on `stream` and returns cudaGetLastError(): 0 when the launch
// was accepted.  The `_bf16` entries take feats, W0f, W0c, U_l, W_l and
// the heads' kernels in bfloat16 (a_l, the biases, uniforms and
// temperatures float32), `proj` [G][L][H] float32 (the scan flavor's
// style terms; null for the fused flavor), `flavor` (1 scan, 2 fused) and
// `cround` (the features are bfloat16, so the chosen note is rounded
// before its style term is added: the scan flavor's), and plan with
// 2-byte weights.

// The cluster kernel, with the plan (C, Gc, clusters, smem) of
// ops/notegen.py::notegen_plan: cudaErrorInvalidValue when it is not
// ng_plan's, the plan is the streamed kernel's, or the widths fit no
// plan.  `feats`, `w0f` and every U_l and W_l must be 16-byte aligned
// (cp.async).  `prof` may be null; else 14 int64 on the card (see the
// kernel).
extern "C" int notegen_launch(
    const float* feats, const float* uniforms, const float* temp,
    const float* w0f, const float* w0c, const void* const* layers,
    const float* wnd, const float* bnd, const float* wvd, const float* bvd,
    const float* vgrid, float* out, int G, int N, int F, int H, int L,
    int hard, int max_velocity, int C, int Gc, int clusters, int smem,
    unsigned long long* prof, void* stream) {
  const NgArgs a{feats, w0f, w0c, wnd, wvd, uniforms, temp, bnd, bvd, vgrid,
                 nullptr, out, G, N, F, H, L, hard, max_velocity, 0};
  return ng_cluster<0>(a, layers, NgPlan{C, Gc, clusters, smem}, prof,
                       stream);
}

extern "C" int notegen_launch_bf16(
    const void* feats, const float* uniforms, const float* temp,
    const void* w0f, const void* w0c, const void* const* layers,
    const void* wnd, const float* bnd, const void* wvd, const float* bvd,
    const float* vgrid, float* out, int G, int N, int F, int H, int L,
    int hard, int max_velocity, const float* proj, int flavor, int cround,
    int C, int Gc, int clusters, int smem, unsigned long long* prof,
    void* stream) {
  const NgArgs a{feats, w0f, w0c, wnd, wvd, uniforms, temp, bnd, bvd, vgrid,
                 proj, out, G, N, F, H, L, hard, max_velocity, cround};
  const NgPlan p{C, Gc, clusters, smem};
  if (flavor == 1) return ng_cluster<1>(a, layers, p, prof, stream);
  if (flavor == 2) return ng_cluster<2>(a, layers, p, prof, stream);
  return (int)cudaErrorInvalidValue;
}

// The clusters of the plan for (G, L, N, F, H) that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *active;
// cudaErrorInvalidValue where the plan is not a cluster's.
extern "C" int notegen_active_clusters(int G, int L, int N, int F, int H,
                                       int* active) {
  return ng_active_clusters<0>(G, L, N, F, H, active);
}

// The same for the bfloat16 instances (both flavors share their plan and
// their shared memory).
extern "C" int notegen_active_clusters_bf16(int G, int L, int N, int F,
                                            int H, int* active) {
  return ng_active_clusters<1>(G, L, N, F, H, active);
}

// The streamed kernel: one block per stream, at any depth 1..8 whose block
// fits (the plan's kernel where no cluster holds the weights, and the
// cluster kernel's yardstick everywhere).
extern "C" int notegen_streamed_launch(
    const float* feats, const float* uniforms, const float* temp,
    const float* w0f, const float* w0c, const void* const* layers,
    const float* wnd, const float* bnd, const float* wvd, const float* bvd,
    const float* vgrid, float* out, int G, int N, int F, int H, int L,
    int hard, int max_velocity, void* stream) {
  const NgArgs a{feats, w0f, w0c, wnd, wvd, uniforms, temp, bnd, bvd, vgrid,
                 nullptr, out, G, N, F, H, L, hard, max_velocity, 0};
  return ng_streamed<0>(a, layers, stream);
}

extern "C" int notegen_streamed_launch_bf16(
    const void* feats, const float* uniforms, const float* temp,
    const void* w0f, const void* w0c, const void* const* layers,
    const void* wnd, const float* bnd, const void* wvd, const float* bvd,
    const float* vgrid, float* out, int G, int N, int F, int H, int L,
    int hard, int max_velocity, const float* proj, int flavor, int cround,
    void* stream) {
  const NgArgs a{feats, w0f, w0c, wnd, wvd, uniforms, temp, bnd, bvd, vgrid,
                 proj, out, G, N, F, H, L, hard, max_velocity, cround};
  if (flavor == 1) return ng_streamed<1>(a, layers, stream);
  if (flavor == 2) return ng_streamed<2>(a, layers, stream);
  return (int)cudaErrorInvalidValue;
}
