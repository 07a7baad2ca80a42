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
// outputs, so nothing fills and nothing is compacted during the pass:
//   k0 (P), s (int32)  the interval's x[0] and size (size kept in 32 bits
//                      as the plain version keeps it);
//   i (int32)          the query position the entry extends to next; it
//                      stops where the entry dies, so a mem starts at i+1;
//   flags (uint8)      bit 0 live, bit 1 emitted (a mem).
// The wrapper compacts the emitted entries at least min_len long into
// v8's rows [x0, x1, x2, start, end, lane] and pulls them in one read.
//
// Layout in the warp (as csrc/bwd_pass.cu): one warp a lane; entry j of
// the lane in thread j % 32, slot j / 32, in registers for the whole pass,
// the slot count S a template parameter picked per launch (4 or 8: the
// seeder's pass 1 and pass 2); a lane longer than 32 * S, which no pass
// of the seeder builds, is walked in 32-entry chunks with its state in the
// outputs, so the kernel stays exact on any lane.
// The lane's query row is staged in shared memory when it fits.
//
// One round of a lane, per live entry, all from the state before the
// round:
//   - first: the entry is the lane's first live one when it is the lane's
//     first entry or the entry before it is dead (fact 1; that neighbour's
//     liveness comes by __shfl_up_sync, across slots and chunks by a
//     carry);
//   - the query base c at i (4 outside the row), and when it is a base the
//     two ranks of c at k0 - 1 and k0 - 1 + s (one O2 row each; every
//     slot's loads are issued before any slot's update);
//   - keeper: c is a base and the new size reaches min_intv; a keeper
//     takes [L2[c] + 1 + rank, size] and moves to i - 1; the first live
//     entry that is no keeper emits; every other non-keeper dies.
// The warp stops when none of its entries is live (__any_sync); a lane
// ends within x0 + 1 rounds. The most rounds any lane ran go to `rounds`.
//
// Bound: memory latency. Over a pass the bytes are 22-34 B of an entry
// (the x[0] and x[2] it starts from, its flag, and its outputs: x[1] is
// never read) and a 32-byte O2 sector for each distinct sub-block its
// ranks touch, the operations about 50 a live entry-round; both are small beside a round's dependent row load (a trip
// to HBM for an index twenty times the L2), which a lane pays once a
// round. The card hides that latency only with many lanes (warps) in
// flight; a warp's threads beyond its lane's entries idle (packing short
// lanes is later work).
#include "o2.cuh"

namespace {

using mpibwa::At;
using mpibwa::O2Fm;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;              // lanes (warps) per block
constexpr int SMEM_MAX = 48 * 1024;   // dynamic shared memory, no opt-in
constexpr unsigned char LIVE = 1, EMITTED = 2;

template <typename P>
struct Args {
  O2Fm<P> fm;
  const unsigned char* q;  // (NL, L) query rows
  long long L;
  int Lp;                  // staged row width, 0 = read in place
  const int* lane_off;     // (NL + 1,)
  const int* x0;           // (NL,) start of each lane's call
  const int* minv;         // (NL,) min_intv of each lane
  int NL;
  const P* ik;             // (E, 3) the forward intervals
  const unsigned char* live_in;  // (E,) bool
  P* k0;
  int* s;
  int* i;
  unsigned char* flags;
  int* rounds;
};

template <typename P>
struct Ent {
  P k0;
  int s, i;
  bool live, emitted;
};

template <typename P>
struct Ext {
  P k0;
  int s;
  bool keeper;
};

template <typename P>
__device__ __forceinline__ Ent<P> load_input(const Args<P>& a, int e,
                                             int i0) {
  Ent<P> x;
  x.k0 = a.ik[3 * (size_t)e];
  x.s = (int)a.ik[3 * (size_t)e + 2];
  x.i = i0;
  x.live = a.live_in[e] != 0;
  x.emitted = false;
  return x;
}

template <typename P>
__device__ __forceinline__ Ent<P> load_state(const Args<P>& a, int e) {
  const unsigned char f = a.flags[e];
  return Ent<P>{a.k0[e], a.s[e], a.i[e], (f & LIVE) != 0,
                (f & EMITTED) != 0};
}

template <typename P>
__device__ __forceinline__ void store_state(const Args<P>& a, int e,
                                            const Ent<P>& x) {
  a.k0[e] = x.k0;
  a.s[e] = x.s;
  a.i[e] = x.i;
  a.flags[e] = (unsigned char)((x.live ? LIVE : 0) |
                               (x.emitted ? EMITTED : 0));
}

// The backward extension of a live entry by the query base at its i: both
// rank loads are issued here, before any warp operation of the round.
template <typename P>
__device__ __forceinline__ Ext<P> extend(const O2Fm<P>& fm,
                                         const unsigned char* q, long long L,
                                         int min_intv, const Ent<P>& x) {
  Ext<P> o{x.k0, x.s, false};
  if (!x.live) return o;
  const int qi = (x.i >= 0 && x.i < L) ? (int)q[x.i] : 4;
  if (qi >= 4) return o;
  const P kq = mpibwa::wsub(x.k0, (P)1);
  const At<P> k = mpibwa::at(fm, kq);
  const At<P> l = mpibwa::at(fm, mpibwa::wadd(kq, (P)x.s));
  const int tk = mpibwa::rank_at(fm, k, qi);
  const int tl = mpibwa::rank_at(fm, l, qi);
  o.s = (int)((unsigned)tl - (unsigned)tk);
  o.k0 = mpibwa::wadd(mpibwa::wadd(mpibwa::pick5(fm.l2, qi), (P)1), (P)tk);
  o.keeper = o.s >= min_intv;
  return o;
}

// The update of one entry after its round; `first` from the state before.
template <typename P>
__device__ __forceinline__ bool update(Ent<P>& x, const Ext<P>& o,
                                       bool first) {
  if (!x.live) return false;
  if (o.keeper) {
    x.k0 = o.k0;
    x.s = o.s;
    x.i = (int)((unsigned)x.i - 1u);  // wraps like the int32 tensors
    return true;
  }
  if (first) x.emitted = true;
  x.live = false;
  return false;
}

// Whether each thread's entry of a 32-entry slot is its lane's first live
// one, from the liveness before the round: the entry before it is the
// thread below, or for thread 0 the last entry of the slot before
// (prev_live, false at the lane's first slot). Updates prev_live to this
// slot's last entry. Every thread of the warp calls it.
__device__ __forceinline__ bool first_live(bool live, bool& prev_live,
                                           int t) {
  const bool below = __shfl_up_sync(FULL, live, 1);
  const bool before = t == 0 ? prev_live : below;
  prev_live = __shfl_sync(FULL, live, 31);
  return live && !before;
}

template <int S, typename P>
__global__ void __launch_bounds__(32 * WARPS) bwd_v8_kernel(Args<P> a) {
  extern __shared__ unsigned char qsm[];
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int ln = blockIdx.x * WARPS + w;
  if (ln >= a.NL) return;  // the whole warp: nothing below syncs the block
  const int e0 = a.lane_off[ln], n = a.lane_off[ln + 1] - e0;
  const int i0 = (int)((unsigned)a.x0[ln] - 1u);
  const int min_intv = a.minv[ln];
  const unsigned char* qg = a.q + (size_t)ln * a.L;
  const bool in_regs = n <= 32 * S;

  Ent<P> x[S];
  bool any = false;
  if (in_regs) {
#pragma unroll
    for (int sl = 0; sl < S; ++sl) {
      const int j = 32 * sl + t;
      x[sl] = j < n ? load_input(a, e0 + j, i0) : Ent<P>{0, 0, 0, false,
                                                          false};
      any = any || x[sl].live;
    }
  } else {  // the state goes to the outputs, walked in chunks from there
    for (int j = t; j < n; j += 32) {
      const Ent<P> y = load_input(a, e0 + j, i0);
      store_state(a, e0 + j, y);
      any = any || y.live;
    }
    __syncwarp();
  }
  any = __any_sync(FULL, any);  // warp-uniform from here on

  const unsigned char* q = qg;
  if (any && a.Lp > 0) {  // the query row into this warp's shared memory
    unsigned char* qw = qsm + w * a.Lp;
    for (long long k = t; k < a.L; k += 32) qw[k] = qg[k];
    __syncwarp();
    q = qw;
  }

  int r = 0;
  while (any && r < a.L + 2) {  // any is warp-uniform
    bool next = false, prev_live = false;
    if (in_regs) {
      bool first[S];
      Ext<P> o[S];
#pragma unroll
      for (int sl = 0; sl < S; ++sl)
        if (32 * sl < n) first[sl] = first_live(x[sl].live, prev_live, t);
#pragma unroll
      for (int sl = 0; sl < S; ++sl)
        if (32 * sl < n) o[sl] = extend(a.fm, q, a.L, min_intv, x[sl]);
#pragma unroll
      for (int sl = 0; sl < S; ++sl)
        if (32 * sl < n) next = update(x[sl], o[sl], first[sl]) || next;
    } else {
      for (int base = 0; base < n; base += 32) {  // warp-uniform bounds
        const int j = base + t;
        Ent<P> y = j < n ? load_state(a, e0 + j)
                         : Ent<P>{0, 0, 0, false, false};
        const bool first = first_live(y.live, prev_live, t);
        const Ext<P> o = extend(a.fm, q, a.L, min_intv, y);
        next = update(y, o, first) || next;
        if (j < n) store_state(a, e0 + j, y);
      }
    }
    ++r;
    any = __any_sync(FULL, next);
  }
  if (in_regs) {
#pragma unroll
    for (int sl = 0; sl < S; ++sl) {
      const int j = 32 * sl + t;
      if (j < n) store_state(a, e0 + j, x[sl]);
    }
  }
  if (a.rounds != nullptr && t == 0) atomicMax(a.rounds, r);
}

template <int S, typename P>
int launch(Args<P> a, cudaStream_t stream) {
  long long Lp = (a.L + 15) & ~15LL;
  if (WARPS * Lp > SMEM_MAX) Lp = 0;  // read the row in place
  a.Lp = (int)Lp;
  const int grid = (a.NL + WARPS - 1) / WARPS;
  bwd_v8_kernel<S, P><<<grid, 32 * WARPS, WARPS * Lp, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_slots(const Args<P>& a, int slots, cudaStream_t st) {
  switch (slots) {
    case 4: return launch<4>(a, st);
    case 8: return launch<8>(a, st);
    default: return -1;
  }
}

template <typename P>
Args<P> make_args(const int2* o2, long long n_rows, const long long* l2,
                  long long primary, long long seq_len,
                  const unsigned char* q, int NL, long long L,
                  const int* lane_off, const int* x0, const int* minv,
                  const void* ik, const unsigned char* live, void* k0,
                  int* s, int* i, unsigned char* flags, int* rounds) {
  Args<P> a;
  a.fm.rows = o2;
  a.fm.n_rows = (P)n_rows;
  for (int c = 0; c < 5; ++c) a.fm.l2[c] = (P)l2[c];
  a.fm.primary = (P)primary;
  a.fm.seq_len = (P)seq_len;
  a.q = q;
  a.L = L;
  a.Lp = 0;
  a.lane_off = lane_off;
  a.x0 = x0;
  a.minv = minv;
  a.NL = NL;
  a.ik = static_cast<const P*>(ik);
  a.live_in = live;
  a.k0 = static_cast<P*>(k0);
  a.s = s;
  a.i = i;
  a.flags = flags;
  a.rounds = rounds;
  return a;
}

}  // namespace

// A whole v8 backward pass in one launch. Returns the cudaError of the
// launch (0 = launched), or -1 for a slot count without an instance. The
// leading arguments are DeviceFMIndex.o2_args() (l2 a host array of five);
// every other pointer is a device pointer. `ik` is (E, 3) and `k0` (E,) in
// the position type (int64 when wide, else int32); `rounds` (one int, may
// be null) receives max(rounds, the pass's round count). The launch goes
// to `stream` and does not synchronise.
extern "C" int mpibwa_bwd_v8(int wide, const int2* o2, long long n_rows,
                             const long long* l2, long long primary,
                             long long seq_len, const unsigned char* q,
                             int NL, long long L, const int* lane_off,
                             const int* x0, const int* minv, const void* ik,
                             const unsigned char* live, int E, int slots,
                             void* k0, int* s, int* i, unsigned char* flags,
                             int* rounds, void* stream) {
  if (NL <= 0 || E <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch_slots(
        make_args<long long>(o2, n_rows, l2, primary, seq_len, q, NL, L,
                             lane_off, x0, minv, ik, live, k0, s, i, flags,
                             rounds),
        slots, st);
  return launch_slots(
      make_args<int>(o2, n_rows, l2, primary, seq_len, q, NL, L, lane_off,
                     x0, minv, ik, live, k0, s, i, flags, rounds),
      slots, st);
}
