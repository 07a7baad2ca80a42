// Fused bwt_occ4 + bidirectional bwt_extend for all four bases, CUDA C++
// for sm_90a.
//
// Replaces the TPU kernel mpibwa_tpu/ops/pallas_occ4.py `extend_pallas`
// (kernel `_extend_kernel`). That kernel takes block rows gathered ahead of
// it and works entry-last on padded blocks of entries; here one thread owns
// one entry, reads its two 48-byte block rows itself and writes its own
// (4, 3) output, so there is no gather pass, no padding and no transpose.
//
// Bound: bytes. An entry reads 12 B of interval and two 48 B rows and writes
// 48 B (156 B) against about 150 integer operations, far below the card's
// operations-per-byte ridge. The two row reads are scattered (one random
// 48-byte row each, 1.5 sectors of 32 B), the interval reads and the output
// writes are contiguous per warp.
#include "occ4.cuh"

namespace {

__global__ void occ4_extend_kernel(mpibwa::FmConst fm,
                                   const int* __restrict__ ik,  // (E, 3)
                                   int E, int is_back,
                                   int* __restrict__ out) {  // (E, 4, 3)
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  int x0 = ik[3 * e], x1 = ik[3 * e + 1], x2 = ik[3 * e + 2];
  int ok_k[4], ok_l[4], ok_s[4];
  // backward extension ranks x[0], forward extension ranks x[1]
  mpibwa::extend4(fm, is_back ? x0 : x1, is_back ? x1 : x0, x2, ok_k, ok_l,
                  ok_s);
  int* o = out + 12 * (size_t)e;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    o[3 * c + 0] = is_back ? ok_k[c] : ok_l[c];
    o[3 * c + 1] = is_back ? ok_l[c] : ok_k[c];
    o[3 * c + 2] = ok_s[c];
  }
}

}  // namespace

// Returns the cudaError of the launch (0 = launched). All pointers are
// device pointers; the launch goes to `stream` and does not synchronise.
extern "C" int mpibwa_occ4_extend(const int* blocks, int n_blocks, int l2_0,
                                  int l2_1, int l2_2, int l2_3, int primary,
                                  const int* ik, int E, int is_back, int* out,
                                  void* stream) {
  if (E <= 0) return 0;
  mpibwa::FmConst fm{blocks, n_blocks, {l2_0, l2_1, l2_2, l2_3}, primary};
  const int threads = 256;
  int grid = (E + threads - 1) / threads;
  occ4_extend_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      fm, ik, E, is_back, out);
  return (int)cudaGetLastError();
}
