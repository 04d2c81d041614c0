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
// The grid is (row blocks, steps): block (x, t) writes rows g0 = x MASK_ROWS
// .. of step t.  A thread owns V consecutive units j0 .. j0 + V - 1 of a row
// (V = 8 in bfloat16, 4 in float32) and writes them with one 16-byte store;
// threadIdx.x walks the row's V-unit chunks, threadIdx.y the rows, and each
// thread loops over MASK_ROWS / blockDim.y rows of its block.  No index is
// divided: the step's part of the hash (seed, site, tile, step) is the same
// for every element the thread writes, so the compiler hoists it out of
// the row loop, and an element costs the hash of r W + col alone (an add,
// three shift-xors, two multiplies, a compare and a select).  Where H is
// not a multiple of V (the tests' odd widths), the rows are not 16-byte
// aligned and the launch takes the scalar instance (V = 1).
//
// What bounds it.  The bytes written, S R H sizeof(T), at 3.35 TB/s, or the
// hash's instructions for the S R H elements at the card's issue rate (132
// SMs x 4 schedulers x 32 lanes a clock): chip_smoke.py counts the
// instructions an element of the row loop from this kernel's SASS and
// reports the larger of the two.

#include "biax_common.cuh"

namespace biax {

constexpr int MASK_THREADS = 256, MASK_ROWS = 32;   // a block

template <typename T, int V>
__global__ void __launch_bounds__(MASK_THREADS) stack_masks_kernel(
    T* __restrict__ out, int R, int H, Drop drop) {
  const int t = blockIdx.y;
  const int g0 = blockIdx.x * MASK_ROWS;
  const int g1 = min(g0 + MASK_ROWS, R);
  T* step = out + (size_t)t * R * H;
  for (int j0 = threadIdx.x * V; j0 < H; j0 += blockDim.x * V) {
#pragma unroll 1
    for (int g = g0 + threadIdx.y; g < g1; g += blockDim.y) {
      T* dst = step + (size_t)g * H + j0;
      if constexpr (V == 1) {
        const int j = j0;
        st<T>(dst, mval(drop, S_STACK_MID, 0, t, g, H, j));
      } else {
        float v[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int j = j0 + e;
          v[e] = mval(drop, S_STACK_MID, 0, t, g, H, j);
        }
        uint4 q;
        if constexpr (std::is_same<T, bf16>::value) {
          q = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                         pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        } else {
          q = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                         __float_as_uint(v[2]), __float_as_uint(v[3]));
        }
        *reinterpret_cast<uint4*>(dst) = q;
      }
    }
  }
}

template <typename T>
int stack_masks(void* out, int S, int R, int H, Drop drop, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = H % V == 0;
  const int chunks = vec ? H / V : H;
  const int tx = chunks < 32 ? chunks : 32;
  const dim3 grid((R + MASK_ROWS - 1) / MASK_ROWS, S);
  const dim3 block(tx, MASK_THREADS / tx);
  if (vec)
    stack_masks_kernel<T, V><<<grid, block, 0, st>>>((T*)out, R, H, drop);
  else
    stack_masks_kernel<T, 1><<<grid, block, 0, st>>>((T*)out, R, H, drop);
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
