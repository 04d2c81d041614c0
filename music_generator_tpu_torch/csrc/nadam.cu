// Keras 2 Nadam's update of many parameter leaves in one launch, as CUDA
// kernels for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's update (ops/nadam.py) is a few
// elementwise expressions that XLA fuses under `jit`.  The port ran the same
// update as plain PyTorch ops (ops/nadam.py::nadam_update_reference), 37 a
// leaf and a fill for each of torch.pow's three scalar bases, so a step of
// DeepJ's 28 leaves issued 1,120 launches for one pass over 35.5 MB.  Here
// that is two launches:
//
//   nadam_update_kernel   every leaf's p, mu and nu, the grid over
//                         (leaf, chunk of kBlockElems elements);
//   nadam_scalars_kernel  one block: every leaf's count and m_schedule
//                         advanced, after the update has read them (a block
//                         of the update that wrote them would race the blocks
//                         that read them).
//
// The leaves' pointers, sizes and first blocks travel by value in the
// kernels' parameter block (NadamLeaves, under 4 KB): no table in device
// memory and no copy to the card.  The gradients are new tensors every step
// (zero_grad(set_to_none=True)), so the wrapper fills the block anew at every
// launch.  Each thread works out its leaf's scalars from that leaf's own
// count and m_schedule, read on the card: no host read.
//
// Bit for bit with the plain version on the card.  Each PyTorch op there is
// its own kernel and rounds its float32 result, so every operation here is a
// rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn),
// which the compiler never contracts into an FMA, in the plain version's
// order; powf is the CUDA library's, as torch.pow's float kernel calls it, and
// the build has no fast math.  The Python scalars arrive as the float32
// values PyTorch's kernels make of them (a C cast of the double).  Nothing is
// summed across threads, so a launch is deterministic.
//
// What bounds it on this card.  One read of p, g, mu, nu and one write of p,
// mu, nu: 28 bytes an element, 35.5 MB for deepj's 1,269,476 parameters (10.6
// us at 3.35 TB/s) and 15.8 MB for the linear time axis's 564,964 (4.7 us).
// A thread updates four consecutive elements with 16-byte loads and stores
// where all four of its leaf's arrays are 16-byte aligned, and one element at
// a time elsewhere and in a chunk's last elements that do not fill four.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;        // leaves a launch carries
constexpr int kThreads = 256;         // threads of an update block
constexpr int kBlockElems = 4096;     // elements an update block takes

}  // namespace

// The arguments of both kernels.  count and m_schedule are each leaf's
// 0-d float32 state; n its elements; block_start[i] the first update block
// of leaf i, block_start[leaves] the update's grid.  The hyperparameters are
// float32: b1, b2, 1 - b1, 1 - b2 (formed in double, then cast), -lr, eps and
// the schedule decay.  ops/nadam.py::_Leaves mirrors this layout.
struct NadamLeaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* mu[kMaxLeaves];
  float* nu[kMaxLeaves];
  float* count[kMaxLeaves];
  float* m_schedule[kMaxLeaves];
  long long n[kMaxLeaves];
  int block_start[kMaxLeaves + 1];
  int leaves;
  float b1, b2, one_minus_b1, one_minus_b2, neg_lr, eps, decay;
};

static_assert(sizeof(NadamLeaves) <= 4096, "a kernel's parameter block");

namespace {

// mom = b1 * (1 - 0.5 * 0.96^(t * decay)), each operation rounded as the
// plain version's 0-d tensors round it.
__device__ __forceinline__ float momentum(float t, float b1, float decay) {
  const float pw = powf(static_cast<float>(0.96), __fmul_rn(t, decay));
  return __fmul_rn(b1, __fsub_rn(1.0f, __fmul_rn(0.5f, pw)));
}

// The per-leaf terms of one step.
struct Step {
  float b1, b2, c1, c2, neg_lr, eps;
  float g_den, m_den, v_den;    // 1 - m_sched, 1 - m_sched_next, 1 - b2^t
  float one_minus_mom_t, mom_t1;
};

__device__ __forceinline__ void update(const Step& s, float& p, float g,
                                       float& mu, float& nu) {
  mu = __fadd_rn(__fmul_rn(mu, s.b1), __fmul_rn(s.c1, g));
  nu = __fadd_rn(__fmul_rn(nu, s.b2), __fmul_rn(__fmul_rn(s.c2, g), g));
  const float g_prime = __fdiv_rn(g, s.g_den);
  const float m_prime = __fdiv_rn(mu, s.m_den);
  const float v_prime = __fdiv_rn(nu, s.v_den);
  const float m_bar = __fadd_rn(__fmul_rn(s.one_minus_mom_t, g_prime),
                                __fmul_rn(s.mom_t1, m_prime));
  p = __fadd_rn(p, __fdiv_rn(__fmul_rn(s.neg_lr, m_bar),
                             __fadd_rn(__fsqrt_rn(v_prime), s.eps)));
}

__global__ void __launch_bounds__(kThreads)
    nadam_update_kernel(const NadamLeaves a) {
  // The block's leaf: the last whose first block is at or before this one
  // (an empty leaf shares its first block with the next leaf).
  const int b = blockIdx.x;
  int leaf = 0, hi = a.leaves - 1;
  while (leaf < hi) {
    const int mid = (leaf + hi + 1) >> 1;
    if (a.block_start[mid] <= b) leaf = mid; else hi = mid - 1;
  }
  float* p = a.p[leaf];
  const float* g = a.g[leaf];
  float* mu = a.mu[leaf];
  float* nu = a.nu[leaf];

  const float t = __fadd_rn(*a.count[leaf], 1.0f);
  const float mom_t = momentum(t, a.b1, a.decay);
  const float mom_t1 = momentum(__fadd_rn(t, 1.0f), a.b1, a.decay);
  const float m_sched = __fmul_rn(*a.m_schedule[leaf], mom_t);
  const float m_sched_next = __fmul_rn(m_sched, mom_t1);
  Step s;
  s.b1 = a.b1;
  s.b2 = a.b2;
  s.c1 = a.one_minus_b1;
  s.c2 = a.one_minus_b2;
  s.neg_lr = a.neg_lr;
  s.eps = a.eps;
  s.g_den = __fsub_rn(1.0f, m_sched);
  s.m_den = __fsub_rn(1.0f, m_sched_next);
  s.v_den = __fsub_rn(1.0f, powf(a.b2, t));
  s.one_minus_mom_t = __fsub_rn(1.0f, mom_t);
  s.mom_t1 = mom_t1;

  const long long begin =
      static_cast<long long>(b - a.block_start[leaf]) * kBlockElems;
  const long long end = min(a.n[leaf], begin + kBlockElems);
  long long e = begin + threadIdx.x;          // the one-element loop's start
  const uintptr_t any = reinterpret_cast<uintptr_t>(p) |
                        reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(mu) |
                        reinterpret_cast<uintptr_t>(nu);
  if ((any & 15) == 0) {
    const long long quads = (end - begin) >> 2;
    for (long long q = threadIdx.x; q < quads; q += kThreads) {
      const long long i = begin + 4 * q;
      float4 pv = *reinterpret_cast<const float4*>(p + i);
      const float4 gv = *reinterpret_cast<const float4*>(g + i);
      float4 mv = *reinterpret_cast<const float4*>(mu + i);
      float4 vv = *reinterpret_cast<const float4*>(nu + i);
      update(s, pv.x, gv.x, mv.x, vv.x);
      update(s, pv.y, gv.y, mv.y, vv.y);
      update(s, pv.z, gv.z, mv.z, vv.z);
      update(s, pv.w, gv.w, mv.w, vv.w);
      *reinterpret_cast<float4*>(p + i) = pv;
      *reinterpret_cast<float4*>(mu + i) = mv;
      *reinterpret_cast<float4*>(nu + i) = vv;
    }
    e = begin + 4 * quads + threadIdx.x;
  }
  for (; e < end; e += kThreads) {
    float pe = p[e], me = mu[e], ve = nu[e];
    update(s, pe, g[e], me, ve);
    p[e] = pe;
    mu[e] = me;
    nu[e] = ve;
  }
}

// count <- count + 1, m_schedule <- m_schedule * mom_t: thread i, leaf i.
__global__ void nadam_scalars_kernel(const NadamLeaves a) {
  const int i = threadIdx.x;
  if (i >= a.leaves) return;
  const float t = __fadd_rn(*a.count[i], 1.0f);
  *a.m_schedule[i] = __fmul_rn(*a.m_schedule[i], momentum(t, a.b1, a.decay));
  *a.count[i] = t;
}

}  // namespace

// This build's layout, for the wrapper to check against its own: the
// leaves a launch carries, the elements an update block takes, and
// sizeof(NadamLeaves).
extern "C" int nadam_layout(int* max_leaves, int* block_elems, int* bytes) {
  *max_leaves = kMaxLeaves;
  *block_elems = kBlockElems;
  *bytes = static_cast<int>(sizeof(NadamLeaves));
  return 0;
}

// One step of the leaves in *a on `stream`: the update over `blocks` =
// a->block_start[a->leaves] blocks (none when every leaf is empty), then
// the scalars.  Returns the CUDA error of the launches (0 = ok).
extern "C" int nadam_step(const NadamLeaves* a, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    nadam_update_kernel<<<blocks, kThreads, 0, st>>>(*a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nadam_scalars_kernel<<<1, kMaxLeaves, 0, st>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
