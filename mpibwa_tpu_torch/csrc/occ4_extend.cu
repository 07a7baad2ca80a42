// Fused bwt_occ4 + bidirectional bwt_extend for all four bases, CUDA C++
// for sm_90a.
//
// Replaces the TPU kernel mpibwa_tpu/ops/pallas_occ4.py `extend_pallas`
// (kernel `_extend_kernel`). That kernel takes block rows gathered ahead of
// it and works entry-last on padded blocks of entries; here one thread owns
// one entry, reads its block rows itself and writes its own (4, 3) output,
// so there is no gather pass, no padding and no transpose.
//
// Bound: bytes. The batch needs 12 B of interval and 48 B of output an
// entry, and each distinct 48-byte block row its ends fall in once, however
// many entries share it; the kernel reads one or two rows an entry (one
// when k-1 and k-1+x2 share a 128-bp block), and a row that other entries
// read too comes from L2 at best. About 150 integer operations an entry:
// far below the card's operations-per-byte ridge. What the design does
// about it:
//   * a row shared by both ends is read once, and the loads of the distinct
//     rows are all issued before any counting (csrc/occ4.cuh extend4), so
//     an entry waits on one round trip to memory, not two;
//   * the 48-byte output of an entry is three 16-byte stores;
//   * the interval reads and the output writes are contiguous per warp;
//     only the row reads are scattered (a 48-byte row touches two 32-byte
//     sectors wherever it lies).
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
  int v[12];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[3 * c + 0] = is_back ? ok_k[c] : ok_l[c];
    v[3 * c + 1] = is_back ? ok_l[c] : ok_k[c];
    v[3 * c + 2] = ok_s[c];
  }
  // the row of an entry is 48 B, so it starts 16-byte aligned
  int4* o = reinterpret_cast<int4*>(out) + 3 * (size_t)e;
  o[0] = make_int4(v[0], v[1], v[2], v[3]);
  o[1] = make_int4(v[4], v[5], v[6], v[7]);
  o[2] = make_int4(v[8], v[9], v[10], v[11]);
}

}  // namespace

// Returns the cudaError of the launch (0 = launched). All pointers are
// device pointers, out 16-byte aligned; the launch goes to `stream` and
// does not synchronise.
extern "C" int mpibwa_occ4_extend(const int* blocks, int n_blocks, int l2_0,
                                  int l2_1, int l2_2, int l2_3, int primary,
                                  const int* ik, int E, int is_back, int* out,
                                  void* stream) {
  if (E <= 0) return 0;
  if (reinterpret_cast<size_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  mpibwa::FmConst fm{blocks, n_blocks, {l2_0, l2_1, l2_2, l2_3}, primary};
  const int threads = 256;
  int grid = (E + threads - 1) / threads;
  occ4_extend_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      fm, ik, E, is_back, out);
  return (int)cudaGetLastError();
}
