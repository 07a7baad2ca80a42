// A whole backward-SMEM pass (bwt.c:326-345, round after round until no
// entry of a lane is live), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel mpibwa_tpu/ops/pallas_bwd.py `_round_call`
// (kernel `_round_kernel`) together with the device while_loop of its
// caller `backward_full` and the gathers that loop does ahead of every
// round: one launch computes what that whole loop computes. The entries of
// all (read, call) lanes of a backward pass lie in one flat state, lane
// after lane, longest match first:
//   state (7, E) int32 = [ik0, ik1, ik2, live, i, last, emitted],
// updated in place. Lanes are independent, so each warp owns one lane and
// runs all of that lane's rounds itself: no launch a round, no grid-wide
// sync, no host check. A warp whose lane has no live entry leaves.
//
// Layout in the warp: entry j of the lane sits in thread j % 32, slot
// j / 32, in registers for the whole pass; the slot count S is a template
// parameter picked per launch from the longest lane. A lane longer than
// 32 * S is walked in 32-entry chunks with its state in device memory
// (coalesced: a chunk is 32 neighbouring entries). The lane's query row is
// staged once into shared memory, unless the row is too long for it.
//
// One round of a lane:
//   - every live entry looks up the query base at its position i and
//     backward-extends its interval (csrc/occ4.cuh: one or two 48-byte
//     block rows, the loads issued before any counting); the extensions of
//     all slots come before any warp operation, so the row loads of the
//     whole lane are in flight together and the lane waits about one
//     memory latency a round;
//   - an entry keeps its extension if it still has min_intv occurrences;
//   - the lane's first live entry (ballot, __ffs, slot by slot) emits a
//     mem if it fails and is not contained in the last one; the mem's new
//     start reaches every entry from the emitter on (ballot under a lane
//     mask, carried across slots);
//   - a keeper whose previous keeper, appended or not, has the same size
//     is dropped (bwt.c:338): the previous keeper is the highest keeper
//     below the thread in its slot (ballot, 31 - __clz, __shfl_sync of its
//     size), or the last keeper of an earlier slot (carried);
//   - survivors take the extension and move to i - 1.
// Each entry's final state is written once; the warp's round count goes to
// `rounds` as a maximum over lanes.
//
// Bound: memory latency, not bandwidth or operations. Over a whole pass the
// bytes are 56 B of state an entry (in and out), the query row and 8 B of
// a lane, and 48 B for each distinct block row the pass reads; the operations
// about 260 an extension. A round of a lane cannot start before the block
// rows of the last round have arrived, so a lane costs about one device
// memory latency a round, and the card hides it only with many lanes in
// flight (one warp each).
#include "occ4.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;  // lanes (warps) per block
constexpr int SMEM_MAX = 48 * 1024;  // dynamic shared memory without opt-in

// v[c] without a dynamically indexed (local-memory) array
__device__ __forceinline__ int sel4(const int v[4], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}

struct Entry {
  int ik0, ik1, ik2, live, i, last, emitted;
};

struct Ext {
  int ok0, ok1, ok2;
  bool keeper;
};

// what the walk down the lane carries from one slot to the next
struct Carry {
  bool live_above;   // a live entry precedes this slot in the lane
  bool seen;         // a mem was emitted above
  bool have_keeper;  // a keeper precedes this slot
  int keeper_s;      // size of the last keeper above
};

struct Cols {
  int* c[7];  // the 7 state rows at the lane's first entry
  __device__ __forceinline__ Entry load(int j) const {
    return Entry{c[0][j], c[1][j], c[2][j], c[3][j], c[4][j], c[5][j],
                 c[6][j]};
  }
  __device__ __forceinline__ void store(int j, const Entry& x) const {
    c[0][j] = x.ik0; c[1][j] = x.ik1; c[2][j] = x.ik2; c[3][j] = x.live;
    c[4][j] = x.i; c[5][j] = x.last; c[6][j] = x.emitted;
  }
};

// the backward extension of a live entry by the query base at its i
__device__ __forceinline__ Ext extend_entry(const mpibwa::FmConst& fm,
                                           const unsigned char* q, int L,
                                           int min_intv, const Entry& x) {
  Ext o{0, 0, 0, false};
  if (x.live != 0) {
    const int i = x.i;
    const int qi = (i >= 0 && i < L) ? (int)q[i] : 4;
    if (i >= 0 && qi < 4) {
      int ok_k[4], ok_l[4], ok_s[4];
      mpibwa::extend4(fm, x.ik0, x.ik1, x.ik2, ok_k, ok_l, ok_s);
      o.ok0 = sel4(ok_k, qi);
      o.ok1 = sel4(ok_l, qi);
      o.ok2 = sel4(ok_s, qi);
      o.keeper = o.ok2 >= min_intv;
    }
  }
  return o;
}

// The carries of one round over one slot (32 entries in lane order, thread
// t holding the t-th); every thread of the warp calls it. Updates x in
// place and returns whether the entry is live after the round.
__device__ __forceinline__ bool step(Entry& x, const Ext& o, Carry& c,
                                     int t) {
  const unsigned lt = (1u << t) - 1u;  // threads below t
  const bool live = x.live != 0;
  const unsigned lm = __ballot_sync(FULL, live);
  const bool first_live = !c.live_above && lm != 0 && t == __ffs(lm) - 1;
  c.live_above = c.live_above || lm != 0;
  // (i + 1) wraps like the int32 tensors of the plain version
  const int start = (int)((unsigned)x.i + 1u);
  const bool emit = first_live && !o.keeper && start < x.last;
  const unsigned em = __ballot_sync(FULL, emit);
  const bool seen = c.seen || (em & (lt | (1u << t))) != 0;
  c.seen = c.seen || em != 0;
  // dedup against the previous keeper (bwt.c:338)
  const unsigned km = __ballot_sync(FULL, o.keeper);
  const unsigned below = km & lt;
  const int prev_s = __shfl_sync(FULL, o.ok2, below ? 31 - __clz(below) : 0);
  const bool has_prev = below ? true : c.have_keeper;
  const int prev = below ? prev_s : c.keeper_s;
  const bool append = o.keeper && (!has_prev || o.ok2 != prev);
  if (km) {  // warp-uniform
    c.keeper_s = __shfl_sync(FULL, o.ok2, 31 - __clz(km));
    c.have_keeper = true;
  }
  if (seen) x.last = start;
  if (emit) x.emitted = 1;
  if (append) {
    x.ik0 = o.ok0; x.ik1 = o.ok1; x.ik2 = o.ok2;
    x.i = (int)((unsigned)x.i - 1u);
  }
  x.live = append ? 1 : 0;
  return append;
}

template <int S>
__global__ void __launch_bounds__(32 * WARPS)
bwd_pass_kernel(mpibwa::FmConst fm, const unsigned char* __restrict__ qrows,
                int L, int Lp, const int* __restrict__ lane_off,
                const int* __restrict__ minv, int NL, int* state, int E,
                int* rounds) {
  extern __shared__ unsigned char qsm[];
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int ln = blockIdx.x * WARPS + w;
  if (ln >= NL) return;  // the whole warp: nothing below syncs the block
  const int e0 = lane_off[ln], n = lane_off[ln + 1] - e0;
  Cols col;
#pragma unroll
  for (int k = 0; k < 7; ++k) col.c[k] = state + k * (size_t)E + e0;
  const int min_intv = minv[ln];
  const unsigned char* qg = qrows + (size_t)ln * L;
  const bool in_regs = n <= 32 * S;

  Entry x[S];
  bool any = false;
  if (in_regs) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = 32 * s + t;
      x[s] = j < n ? col.load(j) : Entry{0, 0, 0, 0, 0, 0, 0};
      any = any || x[s].live != 0;
    }
  } else {
    for (int j = t; j < n; j += 32) any = any || col.c[3][j] != 0;
  }
  any = __any_sync(FULL, any);  // warp-uniform from here on
  if (!any) return;  // no live entry: nothing changes

  const unsigned char* q = qg;
  if (Lp > 0) {  // the query row into this warp's piece of shared memory
    unsigned char* qw = qsm + w * Lp;
    for (int k = t; k < L; k += 32) qw[k] = qg[k];
    __syncwarp();
    q = qw;
  }

  int r = 0;
  while (any && r < L + 2) {  // any is warp-uniform
    Carry c{false, false, false, 0};
    bool next = false;
    if (in_regs) {
      Ext o[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (32 * s < n) o[s] = extend_entry(fm, q, L, min_intv, x[s]);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (32 * s < n) next = step(x[s], o[s], c, t) || next;
    } else {
      for (int base = 0; base < n; base += 32) {
        const int j = base + t;
        Entry y = j < n ? col.load(j) : Entry{0, 0, 0, 0, 0, 0, 0};
        const Ext o = extend_entry(fm, q, L, min_intv, y);
        next = step(y, o, c, t) || next;
        if (j < n) col.store(j, y);
      }
    }
    ++r;
    any = __any_sync(FULL, next);
  }
  if (in_regs) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = 32 * s + t;
      if (j < n) col.store(j, x[s]);
    }
  }
  if (rounds != nullptr && t == 0) atomicMax(rounds, r);
}

template <int S>
int launch(const mpibwa::FmConst& fm, const unsigned char* qrows, int L,
           const int* lane_off, const int* minv, int NL, int* state, int E,
           int* rounds, cudaStream_t stream) {
  int Lp = (L + 15) & ~15;
  if (WARPS * (size_t)Lp > SMEM_MAX) Lp = 0;  // read the row in place
  const int grid = (NL + WARPS - 1) / WARPS;
  bwd_pass_kernel<S><<<grid, 32 * WARPS, WARPS * Lp, stream>>>(
      fm, qrows, L, Lp, lane_off, minv, NL, state, E, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError of the launch (0 = launched), or -1 for a slot
// count without an instance. All pointers are device pointers; `rounds`
// (one int, may be null) receives max(rounds, the pass's round count). The
// launch goes to `stream` and does not synchronise.
extern "C" int mpibwa_bwd_pass(const int* blocks, int n_blocks, int l2_0,
                               int l2_1, int l2_2, int l2_3, int primary,
                               const unsigned char* qrows, int L,
                               const int* lane_off, const int* minv, int NL,
                               int slots, int* state, int E, int* rounds,
                               void* stream) {
  if (NL <= 0 || E <= 0) return 0;
  mpibwa::FmConst fm{blocks, n_blocks, {l2_0, l2_1, l2_2, l2_3}, primary};
  cudaStream_t st = (cudaStream_t)stream;
  switch (slots) {
    case 1: return launch<1>(fm, qrows, L, lane_off, minv, NL, state, E, rounds, st);
    case 2: return launch<2>(fm, qrows, L, lane_off, minv, NL, state, E, rounds, st);
    case 4: return launch<4>(fm, qrows, L, lane_off, minv, NL, state, E, rounds, st);
    case 8: return launch<8>(fm, qrows, L, lane_off, minv, NL, state, E, rounds, st);
    default: return -1;
  }
}
