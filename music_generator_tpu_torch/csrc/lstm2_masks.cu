// The fused two-layer stack's inter-layer dropout masks, written out as one
// [S, R, H] array, as a CUDA kernel for Hopper (sm_90a).
//
// Replaces music_generator_tpu/tools/tpu_validate_lstm2.py `extract_masks`
// (pallas_call at :40): a sibling of the fused stack's kernel that evaluates
// the stack's own mask at every (step, row, unit), so that a validator can
// rebuild the stack in plain code with exactly the masks the kernel applied.
// The TPU kernel evaluated `_mask` of pallas_lstm2.py (hardware-PRNG bits per
// (batch tile, step)); this port's stack (lstm2.cu) draws its mask as
// `mval(drop, S_STACK_MID, 0, t, g, H, j)` of biax_common.cuh, and this
// kernel calls that same function: element (t, g, j) of the output is 1/keep
// in T where the stack keeps h0 and 0 where it drops it.
//
// One thread per element: grid.y walks the steps, grid.x the R*H elements
// of a step in 32-bit index math (one division a thread).  The work is the
// hash and one store per element, so the bound is the bytes written
// (S R H sizeof(T)).

#include "biax_common.cuh"

namespace biax {

constexpr int MASK_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(MASK_THREADS) stack_masks_kernel(
    T* __restrict__ out, int R, int H, Drop drop) {
  const int t = blockIdx.y;
  const int i = blockIdx.x * MASK_THREADS + threadIdx.x;   // g * H + j
  if (i >= R * H) return;
  const int g = i / H;
  const int j = i - g * H;
  st<T>(out + (size_t)t * R * H + i,
        mval(drop, S_STACK_MID, 0, t, g, H, j));
}

template <typename T>
int stack_masks(void* out, int S, int R, int H, Drop drop, cudaStream_t st) {
  const dim3 grid((R * H + MASK_THREADS - 1) / MASK_THREADS, S);
  stack_masks_kernel<T><<<grid, MASK_THREADS, 0, st>>>((T*)out, R, H, drop);
  return (int)cudaGetLastError();
}

}  // namespace biax

// out [S, R, H] in T (bfloat16 when bf16, else float32), R * H < 2^31 and
// S <= 65535 (the wrapper checks); seed, thr and scale as the stack's
// launch takes them (ops/biax.py::_mask_args).
extern "C" int lstm2_masks(int bf16, void* out, int S, int R, int H,
                           unsigned seed, unsigned thr, float scale,
                           void* stream) {
  using namespace biax;
  const Drop drop = {seed, thr, scale, 1};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return stack_masks<biax::bf16>(out, S, R, H, drop, st);
  return stack_masks<float>(out, S, R, H, drop, st);
}
