// The v8 backward-SMEM pass (bwt.c:326-345 under the three facts of
// ops/backward8.py: failures form a prefix of a lane's live entries, no
// dedup or containment check, x[1] kept at its forward value), every lane
// of a pass round after round until no entry is live, in one launch; CUDA
// C++ for sm_90a.
//
// Replaces the device loop of the JAX package's v8 engine,
// mpibwa_tpu/ops/backward8.py `_round8` and the segments, compactions and
// tail of `run_backward8` that drive it (an XLA loop, not a Pallas
// kernel): one launch computes what that whole loop computes, with no host
// read inside the pass. It runs on either index, the int32 one and the
// int64 one that whole genomes need (DeviceFMIndex takes it once seq_len +
// 2 >= 2**31), and it ranks through the O2 table (csrc/o2.cuh: a rank is
// one 8-byte row, the four rows of a sub-block one 32-byte sector), which
// the int64 index holds on the device where it has no classic blocks.
//
// Inputs are v8's entries as seeding_flat.assemble_entries builds them:
// flat, lane after lane (`lane` non-decreasing), longest match first; the
// wrapper (ops/v8_cuda.py) turns the lane column into offsets, the last
// lanes ending at the pass's last live entry (the dead entries that pad a
// pass to its capacity are not walked). Each entry owns one slot of the
// outputs, written once its entry is final:
//   k0 (P), s (int32)  the interval's x[0] and size (size kept in 32 bits
//                      as the plain version keeps it);
//   i (int32)          the query position the entry extends to next; it
//                      stops where the entry dies, so a mem starts at i+1;
//   flags (uint8)      bit 0 live, bit 1 emitted (a mem).
// The wrapper compacts the emitted entries at least min_len long into
// v8's rows [x0, x1, x2, start, end, lane] and pulls them in one read.
//
// One round of a lane, per live entry, all from the state before the
// round:
//   - first: the entry is the lane's first live one when it is the lane's
//     first entry or the entry before it is dead (fact 1 as a rule: it
//     holds on any input);
//   - the query base c at i (4 outside the row), and when it is a base the
//     two ranks of c at k0 - 1 and k0 - 1 + s (one O2 row each);
//   - keeper: c is a base and the new size reaches min_intv; a keeper
//     takes [L2[c] + 1 + rank, size] and moves to i - 1; the first live
//     entry that is no keeper emits; every other non-keeper dies.
// A lane's live entries share i. The most rounds any lane ran go to
// `rounds`.
//
// Bound: memory latency. A round's two rank loads depend on the round
// before, and the index is twenty times the L2, so a lane pays a trip to
// HBM a round; the bytes (22-34 B an entry and a sector a distinct
// sub-block) and the operations (about 50 a live entry-round) are small
// beside it. The card hides that latency only with many warps in flight,
// each of whose threads does useful work. So:
//   - Threads, not warps, hold entries: one entry a thread, a lane's
//     entries in a run of consecutive threads, several lanes to a warp (no
//     lane split across warps, so a round never waits on another warp).
//     A thread's state is one entry's, so the kernel holds few registers
//     and many warps.
//   - Persistent warps: the grid is what the card holds at once; each warp
//     takes lanes in index order (one atomic a lane) into its free threads
//     while the next lane fits, and runs rounds on what it holds. The
//     lanes end at the first that starts at the last entry's end, so the
//     lanes that pad a pass are never taken. The first live test is
//     segmented: a thread heading its lane's run has no predecessor, any
//     other takes its predecessor's liveness by __shfl_up_sync.
//   - Compaction: when the next lane does not fit, the warp writes out its
//     dead entries, moves its live ones down in order (ballot, popcount)
//     and takes the lane into the freed threads. An entry whose entry
//     before it died becomes its run's head: a dead entry stays dead.
//   - The query base of the next round (at i - 1) is loaded with the
//     round's rank loads, so the row read is off the chain of dependent
//     loads.
//   - A lane of more than 32 entries waits for an empty warp and is walked
//     there to its end in 32-entry chunks, its state in the outputs, the
//     chunks one after another each round.
#include "o2.cuh"

namespace {

using mpibwa::At;
using mpibwa::O2Fm;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;  // warps a block
constexpr unsigned char LIVE = 1, EMITTED = 2;

template <typename P>
struct Args {
  O2Fm<P> fm;
  const unsigned char* q;  // (NL, L) query rows
  long long L;
  int NL;
  const int* lane_off;     // (NL + 1,)
  const int* x0;           // (NL,) start of each lane's call
  const int* minv;         // (NL,) min_intv of each lane
  const P* ik;             // (E, 3) the forward intervals
  const unsigned char* live_in;  // (E,) bool
  P* k0;
  int* s;
  int* i;
  unsigned char* flags;
  // [rounds, the next lane to take, warps done, warp-rounds]: the most
  // rounds a lane ran and the rounds the warps ran, summed (each up to
  // date after a launch); the middle two are 0 between launches
  int* ctl;
};

// The base at i of lane ln's row; 4 outside it.
__device__ __forceinline__ int base_at(const unsigned char* q, long long L,
                                       int ln, int i) {
  return (i >= 0 && i < L) ? (int)__ldg(q + (size_t)ln * L + i) : 4;
}

template <typename P>
struct Ext {
  P k0;
  int s;
  bool keeper;
};

// The backward extension of an entry at (k0, s) by base qi (< 4): both
// rank loads are issued here.
template <typename P>
__device__ __forceinline__ Ext<P> extend(const O2Fm<P>& fm, int qi,
                                         int min_intv, P k0, int s) {
  const P kq = mpibwa::wsub(k0, (P)1);
  const At<P> k = mpibwa::at(fm, kq);
  const At<P> l = mpibwa::at(fm, mpibwa::wadd(kq, (P)s));
  const int tk = mpibwa::rank_at(fm, k, qi);
  const int tl = mpibwa::rank_at(fm, l, qi);
  Ext<P> o;
  o.s = (int)((unsigned)tl - (unsigned)tk);
  o.k0 = mpibwa::wadd(mpibwa::wadd(mpibwa::pick5(fm.l2, qi), (P)1), (P)tk);
  o.keeper = o.s >= min_intv;
  return o;
}

// -- one entry a thread --------------------------------------------------------

// The entry a thread holds; compaction moves every field.
template <typename P>
struct Slot {
  P k0;
  int s, i;
  int e;     // its index in the pass
  int ln;    // its lane
  int minv;  // its lane's min_intv
  int born;  // the warp's round when its lane's first round ran
  int qi;    // the query base at i, 4 outside the row
  int bits;  // LIVE, EMITTED, HELD, HEAD
};

constexpr int HELD = 1 << 2, HEAD = 1 << 3;  // beside LIVE and EMITTED

template <typename P>
__device__ __forceinline__ void store(const Args<P>& a, int e, P k0, int s,
                                      int i, unsigned char f) {
  a.k0[e] = k0;
  a.s[e] = s;
  a.i[e] = i;
  a.flags[e] = f;
}

template <typename P>
__device__ __forceinline__ void write_slot(const Args<P>& a,
                                           const Slot<P>& x) {
  store(a, x.e, x.k0, x.s, x.i,
        (unsigned char)(x.bits & (LIVE | EMITTED)));
}

// The position of the n-th (from 0) set bit of m, which has more than n.
__device__ __forceinline__ int nth_set(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// -- lanes of more than 32 entries -------------------------------------------

template <typename P>
struct Ent {
  P k0;
  int s, i;
  bool live, emitted;
};

template <typename P>
__device__ __forceinline__ Ent<P> load_state(const Args<P>& a, int e) {
  const unsigned char f = a.flags[e];
  return Ent<P>{a.k0[e], a.s[e], a.i[e], (f & LIVE) != 0,
                (f & EMITTED) != 0};
}

// Lane ln of n > 32 entries from e0, in an empty warp, to its end. Rounds
// walk its chunks of 32 in turn, each thread's entry from the outputs and
// back, the liveness of the chunk before carried. Adds its chunk-rounds
// to wr and its rounds to rmax.
template <typename P>
__device__ void long_lane(const Args<P>& a, int ln, int e0, int n, int x0,
                          int min_intv, int t, int& rmax, int& wr) {
  const int i0 = (int)((unsigned)x0 - 1u);
  for (int j = t; j < n; j += 32) {
    const size_t e = e0 + j;
    store(a, (int)e, a.ik[3 * e], (int)a.ik[3 * e + 2], i0,
          a.live_in[e] ? LIVE : 0);
  }
  __syncwarp();
  const Ent<P> dead{0, 0, 0, false, false};
  int r = 0;
  bool any = true;
  while (any) {
    bool prev_live = false;
    any = false;
    for (int b = 0; b < n; b += 32) {  // warp-uniform bounds
      const int j = b + t;
      Ent<P> y = j < n ? load_state(a, e0 + j) : dead;
      const bool below = __shfl_up_sync(FULL, y.live, 1);
      const bool first = y.live && !(t == 0 ? prev_live : below);
      prev_live = __shfl_sync(FULL, y.live, 31);
      const int qi = y.live ? base_at(a.q, a.L, ln, y.i) : 4;
      bool keeper = false;
      if (qi < 4) {
        const Ext<P> o = extend(a.fm, qi, min_intv, y.k0, y.s);
        keeper = o.keeper;
        if (keeper) {
          y.k0 = o.k0;
          y.s = o.s;
          y.i = y.i - 1;  // i >= 0 here
        }
      }
      y.emitted = y.emitted || (first && !keeper);
      y.live = keeper;
      if (j < n)
        store(a, e0 + j, y.k0, y.s, y.i,
              (unsigned char)((y.live ? LIVE : 0) |
                              (y.emitted ? EMITTED : 0)));
      any = __any_sync(FULL, y.live) || any;
      ++wr;
    }
    ++r;
  }
  rmax = max(rmax, r);
}

// -- the kernel -----------------------------------------------------------------

// The pending lane of a warp, ln (-1: none left); its fields in thread
// f's pv (0 e0, 1 end, 2 x0, 3 minv), read by shuffle.
struct Pending {
  int ln, pv;
};

// The next lane, taken by the warp; none once a lane starts at `end`, the
// end of the pass's last entry (that lane and every later one are empty).
template <typename P>
__device__ __forceinline__ Pending pop(const Args<P>& a, int end, int t) {
  int ln = 0;
  if (t == 0) ln = atomicAdd(a.ctl + 1, 1);
  ln = __shfl_sync(FULL, ln, 0);
  int pv = 0;
  if (ln < a.NL)
    pv = t == 0 ? __ldg(a.lane_off + ln) : t == 1 ? __ldg(a.lane_off + ln + 1)
       : t == 2 ? __ldg(a.x0 + ln) : __ldg(a.minv + ln);
  if (ln >= a.NL || __shfl_sync(FULL, pv, 0) >= end) ln = -1;
  return Pending{ln, pv};
}

template <typename P>
__device__ __forceinline__ Slot<P> shfl_slot(const Slot<P>& x, int src) {
  Slot<P> y;
  y.k0 = __shfl_sync(FULL, x.k0, src);
  y.s = __shfl_sync(FULL, x.s, src);
  y.i = __shfl_sync(FULL, x.i, src);
  y.e = __shfl_sync(FULL, x.e, src);
  y.ln = __shfl_sync(FULL, x.ln, src);
  y.minv = __shfl_sync(FULL, x.minv, src);
  y.born = __shfl_sync(FULL, x.born, src);
  y.qi = __shfl_sync(FULL, x.qi, src);
  y.bits = __shfl_sync(FULL, x.bits, src);
  return y;
}

// Writes out the warp's dead entries and moves its live ones to threads 0
// .. popc(live) - 1 in order; returns that count. live_below: whether the
// entry below this thread's in its run is live.
template <typename P>
__device__ __forceinline__ int compact(const Args<P>& a, Slot<P>& x,
                                       bool live_below, int t) {
  const bool live = (x.bits & LIVE) != 0;
  if ((x.bits & HELD) && !live) write_slot(a, x);
  if (live && !live_below) x.bits |= HEAD;  // the entry before it died
  const unsigned km = __ballot_sync(FULL, live);
  const int nk = __popc(km);
  x = shfl_slot(x, nth_set(km, t < nk ? t : 0));
  if (t >= nk) x.bits = 0;
  return nk;
}

template <typename P>
__global__ void __launch_bounds__(32 * WARPS) bwd_v8_kernel(Args<P> a) {
  const int t = threadIdx.x & 31;
  const int end = __ldg(a.lane_off + a.NL);
  int rmax = 0, wr = 0;
  Slot<P> x{};
  int held = 0, R = 0;  // threads 0 .. held - 1 hold entries
  Pending p = pop(a, end, t);
  for (;;) {
    while (p.ln >= 0) {  // take lanes while they fit
      const int e0 = __shfl_sync(FULL, p.pv, 0);
      const int n = __shfl_sync(FULL, p.pv, 1) - e0;
      if (held + n > 32) {
        const bool live = (x.bits & LIVE) != 0;
        const bool lb = __shfl_up_sync(FULL, live, 1) && t > 0;
        if (__popc(__ballot_sync(FULL, live)) + min(n, 32) > 32) break;
        held = compact(a, x, lb || (x.bits & HEAD), t);
      }
      const int ln = p.ln;
      const int x0 = __shfl_sync(FULL, p.pv, 2);
      const int mv = __shfl_sync(FULL, p.pv, 3);
      if (n > 32) {  // the warp is empty
        long_lane(a, ln, e0, n, x0, mv, t, rmax, wr);
      } else {
        if (t >= held && t < held + n) {
          x.e = e0 + t - held;
          x.ln = ln;
          x.minv = mv;
          x.born = R;
          x.k0 = a.ik[3 * (size_t)x.e];
          x.s = (int)a.ik[3 * (size_t)x.e + 2];
          x.i = (int)((unsigned)x0 - 1u);
          const bool live = a.live_in[x.e] != 0;
          x.bits = HELD | (live ? LIVE : 0) | (t == held ? HEAD : 0);
          x.qi = live ? base_at(a.q, a.L, ln, x.i) : 4;
        }
        held += n;
      }
      p = pop(a, end, t);
    }
    const bool live = (x.bits & LIVE) != 0;
    if (!__any_sync(FULL, live)) break;  // and no lane is left
    // one round of every lane the warp holds
    const bool below = __shfl_up_sync(FULL, live, 1);
    const bool first = live && ((x.bits & HEAD) || !below);
    if (live) {
      const int qn = base_at(a.q, a.L, x.ln, x.i - 1);  // the next base
      bool keeper = false;
      if (x.qi < 4) {
        const Ext<P> o = extend(a.fm, x.qi, x.minv, x.k0, x.s);
        keeper = o.keeper;
        if (keeper) {
          x.k0 = o.k0;
          x.s = o.s;
          x.i = x.i - 1;  // i >= 0 here
          x.qi = qn;
        }
      }
      if (!keeper) {
        x.bits = (x.bits & ~LIVE) | (first ? EMITTED : 0);
        rmax = max(rmax, R - x.born + 1);
      }
    }
    ++R;
  }
  if (x.bits & HELD) write_slot(a, x);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    rmax = max(rmax, __shfl_xor_sync(FULL, rmax, d));
  if (t == 0) {
    atomicMax(a.ctl, rmax);
    atomicAdd(a.ctl + 3, R + wr);
    // the last warp to finish leaves the lane counter and its own at 0
    __threadfence();
    if (atomicAdd(a.ctl + 2, 1) == (int)(gridDim.x * WARPS) - 1) {
      a.ctl[1] = 0;
      a.ctl[2] = 0;
    }
  }
}

template <typename P>
int launch(Args<P> a, int NL, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bwd_v8_kernel<P>, 32 * WARPS, 0);
  if (rc != cudaSuccess) return (int)rc;
  // what the card holds at once, and no more warps than lanes
  const int grid = max(1, min(per_sm * sms, (NL + WARPS - 1) / WARPS));
  bwd_v8_kernel<P><<<grid, 32 * WARPS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename P>
Args<P> make_args(const int2* o2, long long n_rows, const long long* l2,
                  long long primary, long long seq_len,
                  const unsigned char* q, int NL, long long L,
                  const int* lane_off, const int* x0, const int* minv,
                  const void* ik,
                  const unsigned char* live, void* k0, int* s, int* i,
                  unsigned char* flags, int* ctl) {
  Args<P> a;
  a.fm.rows = o2;
  a.fm.n_rows = (P)n_rows;
  for (int c = 0; c < 5; ++c) a.fm.l2[c] = (P)l2[c];
  a.fm.primary = (P)primary;
  a.fm.seq_len = (P)seq_len;
  a.q = q;
  a.L = L;
  a.NL = NL;
  a.lane_off = lane_off;
  a.x0 = x0;
  a.minv = minv;
  a.ik = static_cast<const P*>(ik);
  a.live_in = live;
  a.k0 = static_cast<P*>(k0);
  a.s = s;
  a.i = i;
  a.flags = flags;
  a.ctl = ctl;
  return a;
}

}  // namespace

// A whole v8 backward pass in one launch. Returns the cudaError of the
// launch (0 = launched). The leading arguments are
// DeviceFMIndex.o2_args() (l2 a host array of five); every other pointer
// is a device pointer. `ik` is (E, 3) and `k0` (E,) in the position type
// (int64 when wide, else int32); `ctl` (four ints,
// the middle two 0) receives max(ctl[0], the pass's round count) and adds
// the warps' rounds to ctl[3]. The launch goes to `stream` and does not
// synchronise.
extern "C" int mpibwa_bwd_v8(int wide, const int2* o2, long long n_rows,
                             const long long* l2, long long primary,
                             long long seq_len, const unsigned char* q,
                             int NL, long long L, const int* lane_off,
                             const int* x0, const int* minv,
                             const void* ik, const unsigned char* live,
                             int E, void* k0, int* s, int* i,
                             unsigned char* flags, int* ctl, void* stream) {
  if (NL <= 0 || E <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch(make_args<long long>(o2, n_rows, l2, primary, seq_len, q,
                                       NL, L, lane_off, x0, minv, ik, live,
                                       k0, s, i, flags, ctl),
                  NL, st);
  return launch(make_args<int>(o2, n_rows, l2, primary, seq_len, q, NL, L,
                               lane_off, x0, minv, ik, live, k0, s, i, flags,
                               ctl),
                NL, st);
}
