// One fused backward-SMEM round (bwt.c:326-345), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel mpibwa_tpu/ops/pallas_bwd.py `_round_call`
// (kernel `_round_kernel`) together with the gathers its caller
// `backward_full` does ahead of every call. State in, state out, one launch
// a round. The entries of all (read, call) lanes of a backward pass lie in
// one flat state, lane after lane, longest match first:
//   state (7, E) int32 = [ik0, ik1, ik2, live, i, last, emitted].
// One thread owns one lane and walks its entries in order, which is the loop
// of bwt.c:326-345 itself: the three per-lane scans of the TPU kernel
// (count of live entries before, "a mem was emitted above", x2 of the last
// keeper) are three scalars carried down the lane. Per live entry it
//   - looks up the query base at the entry's position i,
//   - backward-extends the interval (its block rows read in the kernel:
//     one when both ends of the interval share a 128-bp block, else two,
//     all loads issued before any counting; csrc/occ4.cuh),
//   - keeps it if the extended interval still has min_intv occurrences,
//   - lets the lane's first live entry that fails emit a mem unless it is
//     contained in the last one (flag in its own slot; its i stays where it
//     died, which is the mem's start - 1),
//   - drops a keeper whose previous keeper has the same size (bwt.c:338),
//   - writes survivors in place with i - 1.
// Lanes are independent, so the state is updated in place. A round over a
// state with no live entry changes nothing.
//
// Bound: bytes. A live entry reads and writes its 7 state words, reads its
// query base and one or two 48-byte block rows; the lane reads its offsets
// and min_intv once. The walk down a lane is serial and neighbouring threads
// read entries a lane length apart, so the state traffic is not coalesced:
// the design is the simple one that is exact.
#include "occ4.cuh"

namespace {

// v[c] without a dynamically indexed (local-memory) array
__device__ __forceinline__ int sel4(const int v[4], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}

__global__ void bwd_round_kernel(mpibwa::FmConst fm,
                                 const unsigned char* __restrict__ qrows,
                                 int L, const int* __restrict__ lane_off,
                                 const int* __restrict__ minv, int NL,
                                 int* __restrict__ state, int E) {
  int ln = blockIdx.x * blockDim.x + threadIdx.x;
  if (ln >= NL) return;
  int e0 = lane_off[ln], e1 = lane_off[ln + 1];
  int* ik0 = state;
  int* ik1 = state + (size_t)E;
  int* ik2 = state + 2 * (size_t)E;
  int* live = state + 3 * (size_t)E;
  int* i_e = state + 4 * (size_t)E;
  int* last_e = state + 5 * (size_t)E;
  int* emitted = state + 6 * (size_t)E;
  const unsigned char* q = qrows + (size_t)ln * L;
  int min_intv = minv[ln];

  bool live_above = false;  // a live entry precedes this one in the lane
  bool seen = false;        // a mem was emitted at or above this entry
  bool have_keeper = false;
  int keeper_s = 0;         // x2 of the last keeper above
  for (int e = e0; e < e1; ++e) {
    int i = i_e[e];
    bool is_live = live[e] != 0;
    bool keeper = false;
    int ok0 = 0, ok1 = 0, ok2 = 0;
    if (is_live) {
      int qi = (i >= 0 && i < L) ? (int)q[i] : 4;
      if (i >= 0 && qi < 4) {
        int ok_k[4], ok_l[4], ok_s[4];
        mpibwa::extend4(fm, ik0[e], ik1[e], ik2[e], ok_k, ok_l, ok_s);
        ok0 = sel4(ok_k, qi); ok1 = sel4(ok_l, qi); ok2 = sel4(ok_s, qi);
        keeper = ok2 >= min_intv;
      }
    }
    bool first_live = is_live && !live_above;
    live_above = live_above || is_live;
    // (i + 1) wraps like the int32 tensors of the plain version
    int start = (int)((unsigned)i + 1u);
    bool emit = first_live && !keeper && start < last_e[e];
    seen = seen || emit;
    if (seen) last_e[e] = start;
    if (emit) emitted[e] = 1;
    bool append = keeper && (!have_keeper || ok2 != keeper_s);
    if (keeper) {
      have_keeper = true;
      keeper_s = ok2;
    }
    if (append) {
      ik0[e] = ok0; ik1[e] = ok1; ik2[e] = ok2;
      i_e[e] = (int)((unsigned)i - 1u);
    }
    if (is_live != append) live[e] = append ? 1 : 0;
  }
}

}  // namespace

// Returns the cudaError of the launch (0 = launched). All pointers are
// device pointers; the launch goes to `stream` and does not synchronise.
extern "C" int mpibwa_bwd_round(const int* blocks, int n_blocks, int l2_0,
                                int l2_1, int l2_2, int l2_3, int primary,
                                const unsigned char* qrows, int L,
                                const int* lane_off, const int* minv, int NL,
                                int* state, int E, void* stream) {
  if (NL <= 0 || E <= 0) return 0;
  mpibwa::FmConst fm{blocks, n_blocks, {l2_0, l2_1, l2_2, l2_3}, primary};
  const int threads = 128;
  int grid = (NL + threads - 1) / threads;
  bwd_round_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      fm, qrows, L, lane_off, minv, NL, state, E);
  return (int)cudaGetLastError();
}
