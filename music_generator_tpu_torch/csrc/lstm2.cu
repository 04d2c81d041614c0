// One DeepJ axis as a fused two-layer LSTM stack, as CUDA kernels for Hopper
// (sm_90a): forward and backward of two stacked layers scanning S steps over
// R rows, both input projections inside the stack.
//
// Replaces music_generator_tpu/ops/pallas_lstm2.py: `_forward_impl` (kernel
// `_make_fwd_kernel`) and `_bwd_impl` (kernel `_make_bwd_kernel`, custom VJP
// `_make_stack`).  Per step t and row: layer 0 (z = (x0 W0 -> T) + b0 +
// (h U0 -> T)) -> x1 = h0 * mask + s1m in T -> layer 1 (z = (x1 W1 -> T) +
// b1 + (h U1 -> T)) -> hs1.  Tapes hs0, cs0 (the previous c), cs1 in T, only
// when the caller will differentiate; the terminal states in float32 (h not
// rounded).  The cotangent of h0T is not an input of the backward: the TPU
// kernel ignores it too.
//
// The inter-layer mask.  The TPU kernel draws it from the TPU's hardware
// PRNG per (batch tile, step); no other device gives those bits.  Here an
// element (t, row g, unit j) keeps when the Murmur3 finalizer `mval`
// (biax_common.cuh) at site S_STACK_MID, tile 0, step t, row g of the whole
// row space clears the TPU kernel's threshold: a pure function of (seed,
// t, g, j), whatever rows a block owns (ops/lstm2.py::keep_mask is the
// same function in torch).
//
// What bounds it on this card.  At the flagship shapes the time axis runs
// S = 128, R = 768, F = 94, H = 256 and the note axis S = 48, R = 2048,
// F = 259, H = 128.  The forward does 2 S R (F + 3H) 4H + 20 S R 4H
// operations (the Pallas CostEstimate): 174 GFLOP on the time axis, 0.18 ms
// at 989 TFLOP/s bf16, against some 0.06 ms for its bytes at 3.35 TB/s.  The
// backward does 3x the products.  The real floor is the chain of S
// dependent steps, each a product with U (one layer's 512 KB bf16 at the
// time axis, 128 KB at the note axis).
//
// Forward (simple first, biax_time.cu's design before its passes): one
// block owns RB rows for the whole scan and keeps h, c, the gates and the
// layer inputs in shared memory; the weights stream from L2 every step.
// bf16 products run on the tensor cores (mma.sync, float32 accumulation),
// float32 on the CUDA cores.
//
// Backward, as passes on the machinery of biax_passes.cuh with (S, A, B) =
// (S, 1, R): row g of a step is tile 0, row g of `row_pos`, the indexing of
// the mask.  Of the eight products a step of the TPU kernel makes, only
// dh1 <- dz1 U1^T and dh0 <- dz0 U0^T carry from step to step; the rest
// depend on tapes the forward wrote, so they run over all S R rows at once:
//   1. the prologue (a warp a row): xp = x0 with rows padded to 8 values,
//      x1 = (hs0 * mask -> T) + s1m -> T, rows padded to 8;
//   2. both layers' pre-activations z = ((in W -> T) + b) + (h_{t-1} U ->
//      T), two GEMMs (EPI_PRE); the h_{t-1} tapes hold h0 in their first R
//      rows, so their operand takes no shift;
//   3. layer 1's reversed scan (launch_scan): the cell backward from z1 and
//      the c tape, dh = (dz1 U1^T) + dhs1, dz1 written over z1; dc seeded
//      with the cotangent of c1_T, and dh10 = dz1_0 U1^T and the last dc
//      carry written at its end (ScanEnds);
//   4. dx1 = dz1 W1^T (EPI_STACK_DX1): ds1m = dx1 -> T and the mid term
//      dx1 * mask in float32;
//   5. layer 0's reversed scan, as 3. with the mid term for dhs;
//   6. dx0 = dz0 W0^T -> T (EPI_STACK_DX0);
//   7. the weight gradients, the deterministic reduction biax_wgrad
//      (biax_common.cuh) over the dz tapes, which also replaces the TPU
//      kernel's VMEM sums across its sequential grid.
// bfloat16 scans keep U resident in a thread-block cluster (4 blocks at
// H = 256, one at H = 128); float32 scans stream U^T from L2.  The wrapper
// (ops/lstm2.py::lstm2_bwd) forms the tapes before pass 1: the h_{t-1}
// tapes, and dhs1 with the cotangent of h1_T added to its last step in
// float32, then rounded to T.

#include "biax_passes.cuh"

namespace biax {

struct StackDims { int S, R, F, H; };

template <typename T, int RB>
__global__ void __launch_bounds__(1024) stack_fwd_kernel(
    const T* __restrict__ x0, const T* __restrict__ s1m,
    const T* __restrict__ w0, const T* __restrict__ b0,
    const T* __restrict__ b1, const T* __restrict__ u0,
    const T* __restrict__ w1, const T* __restrict__ u1,
    const float* __restrict__ h00, const float* __restrict__ c00,
    const float* __restrict__ h10, const float* __restrict__ c10, T* hs0,
    T* cs0, T* hs1, T* cs1, float* h0T, float* c0T, float* h1T, float* c1T,
    StackDims d, Drop drop, int hard) {
  extern __shared__ float sm[];
  const int F = d.F, H = d.H, H4 = 4 * H, R = d.R;
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
  for (int i = tid; i < RB * (lF + lH); i += nt) sm[i] = 0.f;
  for (int i = tid; i < RB * lH; i += nt) {
    const int j = i % lH, g = g0 + i / lH;
    const bool in = j < H && g < R;
    h0[i] = in ? rnd<T>(h00[(size_t)g * H + j]) : 0.f;
    h1[i] = in ? rnd<T>(h10[(size_t)g * H + j]) : 0.f;
  }
  for (int i = tid; i < RB * H; i += nt) {
    const int g = g0 + i / H;
    c0[i] = g < R ? c00[(size_t)g * H + i % H] : 0.f;
    c1[i] = g < R ? c10[(size_t)g * H + i % H] : 0.f;
  }
  __syncthreads();
  for (int t = 0; t < d.S; ++t) {
    const size_t row0 = (size_t)t * R + g0;
    for (int i = tid; i < RB * F; i += nt) {
      const int rr = i / F, f = i % F;
      xin[rr * lF + f] = g0 + rr < R ? ld(x0 + row0 * F + i) : 0.f;
    }
    __syncthreads();
    preact<T, RB>(xin, lF, F, w0, b0, h0, lH, H, u0, z, scr);
    for (int i = tid; i < RB * H; i += nt) {
      const int rr = i / H, j = i % H, g = g0 + rr;
      const Gates q = gates<T>(z + rr * H4, H, j, hard);
      const float cp = c0[i];
      float hn;
      const float cn = cell<T>(q, cp, &hn);
      c0[i] = cn;
      h0[rr * lH + j] = hn;
      float xv = 0.f;
      if (g < R) {
        const size_t o = row0 * H + i;
        if (cs0) st(cs0 + o, cp);
        if (hs0) st(hs0 + o, hn);
        if (t == d.S - 1) {
          h0T[(size_t)g * H + j] = __fmul_rn(q.o, tanh_t<T>(rnd<T>(cn)));
          c0T[(size_t)g * H + j] = cn;
        }
        const float hv =
            drop.on ? mul_t<T>(hn, mval(drop, S_STACK_MID, 0, t, g, H, j))
                    : hn;
        xv = add_t<T>(hv, ld(s1m + o));
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
      const float cn = cell<T>(q, cp, &hn);
      c1[i] = cn;
      h1[rr * lH + j] = hn;
      if (g < R) {
        const size_t o = row0 * H + i;
        if (cs1) st(cs1 + o, cp);
        st(hs1 + o, hn);
        if (t == d.S - 1) {
          h1T[(size_t)g * H + j] = __fmul_rn(q.o, tanh_t<T>(rnd<T>(cn)));
          c1T[(size_t)g * H + j] = cn;
        }
      }
    }
    __syncthreads();
  }
}

constexpr int FWD_RB = 8;   // 96 blocks on the time axis, 256 on the note axis

template <typename T>
int stack_fwd(void* const* p, StackDims d, Drop drop, int hard,
              cudaStream_t st) {
  const int H4 = 4 * d.H, nt = threads_for(H4), RB = FWD_RB;
  const size_t smem = sizeof(float) *
      (RB * (padk(d.F) + 3 * padk(d.H) + 2 * d.H + H4) + (size_t)nt * RB);
  auto kern = stack_fwd_kernel<T, FWD_RB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<(d.R + RB - 1) / RB, nt, smem, st>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const float*)p[8], (const float*)p[9], (const float*)p[10],
      (const float*)p[11], (T*)p[12], (T*)p[13], (T*)p[14], (T*)p[15],
      (float*)p[16], (float*)p[17], (float*)p[18], (float*)p[19], d, drop,
      hard);
  return (int)cudaGetLastError();
}

// Backward 1.: the layer inputs of every (t, row g) m = t R + g, a warp a
// row: xp[m] = x0[m] and x1[m] = (hs0[m] * mask -> T) + s1m[m] -> T (the cast
// order of the forward), each row padded to 8 values with zeros.
constexpr int PRO_ROWS = 8;   // rows (warps) a block

template <typename T>
__global__ void __launch_bounds__(32 * PRO_ROWS) stack_prologue_kernel(
    const T* __restrict__ x0, const T* __restrict__ s1m,
    const T* __restrict__ hs0, T* __restrict__ xp, T* __restrict__ x1,
    StackDims d, Drop drop) {
  const int F = d.F, H = d.H, R = d.R, lx = pad8(F), l1 = pad8(H);
  const size_t m = (size_t)blockIdx.x * PRO_ROWS + threadIdx.x / 32;
  if (m >= (size_t)d.S * R) return;
  const int t = (int)(m / R), g = (int)(m % R), lane = threadIdx.x % 32;
  for (int c = lane; c < lx; c += 32)
    st(xp + m * lx + c, c < F ? ld(x0 + m * F + c) : 0.f);
  for (int j = lane; j < l1; j += 32) {
    float v = 0.f;
    if (j < H) {
      float hv = ld(hs0 + m * H + j);
      if (drop.on) hv = mul_t<T>(hv, mval(drop, S_STACK_MID, 0, t, g, H, j));
      v = add_t<T>(hv, ld(s1m + m * H + j));
    }
    st(x1 + m * l1 + j, v);
  }
}

}  // namespace biax

// Matrices in the layout of the compute dtype (see matvec in
// biax_common.cuh); b0, b1 in T; initial states float32.  Pointers, in
// order: x0 s1m w0 b0 b1 u0 w1 u1 h00 c00 h10 c10 | hs0 cs0 hs1 cs1 (hs0,
// cs0, cs1 may be null) h0T c0T h1T c1T.
extern "C" int lstm2_fwd(
    int bf16, void* x0, void* s1m, void* w0, void* b0, void* b1, void* u0,
    void* w1, void* u1, void* h00, void* c00, void* h10, void* c10, void* hs0,
    void* cs0, void* hs1, void* cs1, void* h0T, void* c0T, void* h1T,
    void* c1T, int S, int R, int F, int H, unsigned seed, unsigned thr,
    float scale, int dropout, int hard, void* stream) {
  using namespace biax;
  void* const p[] = {x0,  s1m, w0,  b0,  b1,  u0,  w1,  u1,  h00, c00,
                     h10, c10, hs0, cs0, hs1, cs1, h0T, c0T, h1T, c1T};
  const StackDims d = {S, R, F, H};
  const Drop drop = {seed, thr, scale, dropout};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return stack_fwd<biax::bf16>(p, d, drop, hard, st);
  return stack_fwd<float>(p, d, drop, hard, st);
}


// The backward's passes, launched in order by ops/lstm2.py::lstm2_bwd.
// 1. The prologue over M = S R rows: xp [M][pad8(F)] = x0 [M][F] padded
// with zeros, x1 [M][pad8(H)] = (hs0 * mask -> T) + s1m -> T padded with
// zeros.
extern "C" int lstm2_bwd_prologue(int bf16, const void* x0, const void* s1m,
                                  const void* hs0, void* xp, void* x1, int S,
                                  int R, int F, int H, unsigned seed,
                                  unsigned thr, float scale, int dropout,
                                  void* stream) {
  using namespace biax;
  const StackDims d = {S, R, F, H};
  const Drop drop = {seed, thr, scale, dropout};
  const int blocks = (int)(((size_t)S * R + PRO_ROWS - 1) / PRO_ROWS);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    stack_prologue_kernel<biax::bf16><<<blocks, 32 * PRO_ROWS, 0, st>>>(
        (const biax::bf16*)x0, (const biax::bf16*)s1m,
        (const biax::bf16*)hs0, (biax::bf16*)xp, (biax::bf16*)x1, d, drop);
  else
    stack_prologue_kernel<float><<<blocks, 32 * PRO_ROWS, 0, st>>>(
        (const float*)x0, (const float*)s1m, (const float*)hs0, (float*)xp,
        (float*)x1, d, drop);
  return (int)cudaGetLastError();
}

// 2. One layer's pre-activations z [M][4H] = ((xin W -> T) + bias) + (hp U
// -> T) over all M rows (EPI_PRE): xin [M][ldx] with K columns, hp [M][H]
// the h_{t-1} tape (no shift: its first R rows hold the initial h), w and u
// in the layout of T.
extern "C" int lstm2_bwd_preact(int bf16, const void* xin, int ldx, int K,
                                const void* w, const void* bias,
                                const void* hp, const void* u, void* z, int M,
                                int H, void* stream) {
  using namespace biax;
  const int H4 = 4 * H;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    const EpiArgs<biax::bf16> e = {(biax::bf16*)z, (const biax::bf16*)bias};
    return gemm<biax::bf16, EPI_PRE>(
        operand<biax::bf16>(xin, ldx, 0, K, w, H4),
        operand<biax::bf16>(hp, H, 0, H, u, H4), M, H4, e, st);
  }
  const EpiArgs<float> e = {(float*)z, (const float*)bias};
  return gemm<float, EPI_PRE>(operand<float>(xin, ldx, 0, K, w, H4),
                              operand<float>(hp, H, 0, H, u, H4), M, H4, e,
                              st);
}

// 3., 5. One layer's reversed scan over z_dz (z in, dz out) with the
// external dh ext_t (T) or ext_f (float32) [S][R][H], the c_{t-1} tape cs,
// dc seeded from dcT, and the initial-state gradients dh0, dc0 [R][H]
// written at its end (launch_scan with ScanEnds).  cluster = 1 (bfloat16
// only): u is U [H][4H], resident in a thread-block cluster; cluster = 0: u
// is `_layout(U^T)`, streamed.  prof as for the stacks' scans (may be
// null).
extern "C" int lstm2_bwd_scan(int bf16, int cluster, void* z_dz,
                              const void* cs, const void* ext_t,
                              const float* ext_f, const void* u,
                              const float* dcT, float* dh0, float* dc0,
                              int S, int R, int H, int hard,
                              unsigned long long* prof, void* stream) {
  using namespace biax;
  const PassDims d = {S, 1, R, H, 1};
  const ScanEnds ends = {dcT, dh0, dc0};
  return launch_scan(bf16, cluster, z_dz, cs, ext_t, ext_f, u, d, hard, prof,
                     (cudaStream_t)stream, ends);
}

// 4., 6. The product dz [M][4H] W^T (wt = `_layout(W^T)`, an Nout-wide
// result).  layer 1 (EPI_STACK_DX1): out_t = ds1m (T), out_b = the mid term
// (float32); layer 0 (EPI_STACK_DX0): out_t = dx0 (T).
extern "C" int lstm2_bwd_dx(int bf16, int layer, const void* dz,
                            const void* wt, int S, int R, int H, int Nout,
                            void* out_t, float* out_b, unsigned seed,
                            unsigned thr, float scale, int dropout,
                            void* stream) {
  using namespace biax;
  const PassDims d = {S, 1, R, H, 1};
  const Drop drop = {seed, thr, scale, dropout};
  const int M = S * R, H4 = 4 * H;
  cudaStream_t st = (cudaStream_t)stream;
  return layer ? launch_dx<EPI_STACK_DX1>(bf16, dz, wt, M, H4, Nout, out_t,
                                          nullptr, out_b, nullptr, 0, d, drop,
                                          st)
               : launch_dx<EPI_STACK_DX0>(bf16, dz, wt, M, H4, Nout, out_t,
                                          nullptr, nullptr, nullptr, 0, d,
                                          drop, st);
}
