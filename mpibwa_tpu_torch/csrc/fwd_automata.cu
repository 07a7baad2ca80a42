// The forward SMEM automata of mem_collect_intv (bwt.c:281-379), a whole
// batch of reads in one launch, CUDA C++ for sm_90a. Two entry points:
//
//   forward_p3_kernel   the chained pass-1 automaton (bwt_smem1 from 0,
//                       then from each call's return) and the pass-3 sweep
//                       (bwt_seed_strategy1) of every read;
//   forward_pass_kernel the pass-1 automaton alone (chain = 1), or one call
//                       a lane from a given start with a per-lane min_intv
//                       (chain = 0: pass 2's re-seeding).
//
// They replace the device while_loops of mpibwa_tpu/ops/seeding.py
// `forward_p3` and `forward_pass` (XLA programs, not Pallas kernels): one
// launch computes what the whole loop computes. The JAX loop and the plain
// PyTorch version (ops/seeding.py) step every lane in lockstep, one
// interval extension a round, until the last lane is done. A lane's
// outputs do not depend on the round (lanes are independent and a lane
// that is done no longer changes), and within a read pass 1 and pass 3
// share nothing but the read, so here each automaton of each read runs to
// its own end: the same transitions in the same order, no launch a round,
// no host check.
//
// Bound: a chain of dependent steps. A step's O2 rows are known only once
// the step before has produced its interval, so the launch lasts at least
// its longest lane's steps times one dependent load (the O2 table is about
// 1 GB on a human chromosome, twenty times the L2 cache: a trip to HBM,
// about 0.37 us for a lone thread on an H100) plus the step's own
// instructions; and all lanes' steps together need the card's rate of
// random 32-byte loads (about 36-38 G a second on an H100, far below its
// streaming rate). The bytes alone are small beside both (a sector a
// position, the reads once, the outputs). The first design (one thread a
// read, both automata back to back, 64-thread blocks) took 3.2-7.9 us a
// step on an H100 where a lone lane took 1.0-1.2 us: with one thread a
// read only about 4 warps an SM were in flight, a round was about a
// thousand dependent instructions (two automata of four ranks each), and
// lanes in other states and automata diverged within a warp. This design
// takes about 1.5 us a step at 16,384 reads (0.5 us for a lone lane), its
// sector loads at a large share of that random-load rate; with the table
// in the L2 cache (a 3 Mbp genome) a step still takes about 1.2 us,
// so the step's instructions weigh about as much as its loads
// (chip_smoke.py phase 2g and --fwd-turns).
//
// The design:
// - Roles. In forward_p3_kernel the first half of a block's warps run pass
//   1 for the block's reads and the second half pass 3 for the same reads:
//   each role is warp-uniform and ends with its own automaton.
// - Groups. G = 4 threads (a quad) hold one automaton's state in lockstep.
//   Of the four ranks a step needs ((k, cb), (k, eb), (l, cb), (l, eb)),
//   each thread loads the one 8-byte row of its own, in one or two 32-byte
//   sectors, and the quad exchanges the four ranks by shuffles
//   (csrc/o2.cuh fwd_ranks); every thread then computes the same update.
//   A step's chain is one rank, not four, and a read brings 8 threads
//   (forward_p3) or 4 (forward_pass) instead of one: about 31 warps an SM
//   at 16,384 reads (32,768 pass-2 lanes) instead of 4. The group's writes
//   are spread over its threads.
// - Staged reads. A block's reads are contiguous rows of q; where they fit
//   in STAGE_MAX bytes of shared memory, the block copies them in once, in
//   aligned 16-byte words, and a step reads its base there. Wider rows
//   (long reads, up to 2**21 bp) are read in place (Lp = 0).
// - 32-bit sub-block and row arithmetic on the int32 path (csrc/o2.cuh),
//   and __launch_bounds__ that keep every group of a launch resident.
//
// Outputs are written straight into the plain version's arrays (FwdOut,
// Pass3Out), which the wrapper zero-fills: a push past F_CAP (a seed past
// S3_CAP) is counted and flagged, not written, and the lane runs on to its
// end, as in the JAX package; a call past C_CAP flags the lane and ends it.
#include <stdint.h>

#include "o2.cuh"

namespace {

using mpibwa::At;
using mpibwa::O2Fm;

constexpr int SEEK = 0, EXT = 1, DONE = 2;
constexpr int THREADS = 256;  // a block: 8 warps
constexpr int G = 4;          // threads an automaton (a group)
constexpr int STAGE_MAX = 24 * 1024;  // bytes of a block's staged reads

// blocks an SM the registers must leave room for (at most 64 registers a
// thread): every group of a 16,384-read forward_p3 or a 32,768-lane
// forward_pass launch resident at once, at either position type
constexpr int MIN_BLOCKS = 4;

template <typename P>
struct FwdArgs {
  O2Fm<P> fm;
  const unsigned char* q;  // (B, L) nt4 codes, pads >= 4
  int B;
  long long L;
  const int* lens;  // (B,)
  const P* minv;    // (B,)
  int f_cap, c_cap;
  P* ivals; int* infos; int* n_pushed; int* call_x; int* call_start;
  int* call_len; int* n_calls; unsigned char* overflow;
};

// The arrays of Pass3Out.
template <typename P>
struct P3Args {
  P* seeds;          // (B, S3_CAP, 3)
  long long* infos;  // (B, S3_CAP) start << 32 | end
  int* n_seeds;
  unsigned char* overflow;
  int s3_cap;
  int min_seed_len;
  long long max_intv;
};

// One automaton's place: its read b, its thread t in the group, the
// group's lanes, and the read's row (in shared memory or in place).
struct Lane {
  int b, t;
  unsigned mask;
  const unsigned char* row;
  long long L;

  // Base of the read at pos, 4 outside its row (ops/seeding._query_at).
  __device__ __forceinline__ int base(int pos) const {
    return (pos >= 0 && pos < L) ? (int)row[pos] : 4;
  }
  // whether this thread writes item j of a group's write
  __device__ __forceinline__ bool writes(int j) const {
    return (j & (G - 1)) == t;
  }
};

// Copies the block's n reads from read b0 into shared memory, whole
// aligned 16-byte words (an aligned word that holds a byte of q lies in
// q's allocation); returns the offset of read b0's first byte there.
__device__ __forceinline__ int stage_reads(const unsigned char* q,
                                           long long L, int b0, int n,
                                           int4* smem) {
  const uintptr_t s0 = reinterpret_cast<uintptr_t>(q + (long long)b0 * L);
  const int off = (int)(s0 & 15);
  const int4* src = reinterpret_cast<const int4*>(s0 - off);
  const int words = (int)((off + n * L + 15) >> 4);
  for (int j = threadIdx.x; j < words; j += THREADS) smem[j] = __ldg(src + j);
  __syncthreads();
  return off;
}

// The lane of thread r (0-based within its role) of a block whose reads
// start at b0, reading its row from shared memory when Lp > 0.
template <typename P>
__device__ __forceinline__ Lane lane_of(const FwdArgs<P>& a, int b0, int r,
                                        long long Lp, const int4* smem,
                                        int off) {
  Lane ln;
  const int j = r / G;
  ln.b = b0 + j;
  ln.t = r & (G - 1);
  ln.mask = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  ln.L = a.L;
  ln.row = Lp > 0
      ? reinterpret_cast<const unsigned char*>(smem) + off + j * Lp
      : a.q + (long long)ln.b * a.L;
  return ln;
}

// The pass-1/pass-2 automaton of one lane (ops/seeding._Fwd), held by each
// thread of its group.
template <typename P>
struct Fwd {
  int x, kind, info, i, n_pushed, n_calls, cur_start;
  P ik0, ik1, ik2;
  bool overflow;

  __device__ void init(int x0) {
    x = x0; kind = SEEK; info = 0; i = 0; n_pushed = 0; n_calls = 0;
    cur_start = 0; ik0 = ik1 = ik2 = 0; overflow = false;
  }

  // Seek: start a call at x, skip an ambiguous base (chain) or stop at it
  // (single call: no mems, bwt.c:296), or finish at the read's end.
  __device__ void seek(const FwdArgs<P>& a, const Lane& ln, int len,
                       bool chain) {
    const int qx = ln.base(x);
    if (x >= len) {
      kind = DONE;
    } else if (qx > 3) {
      if (chain) ++x; else kind = DONE;
    } else if (n_calls >= a.c_cap) {
      overflow = true;
      kind = DONE;
    } else {
      const long long c = (long long)ln.b * a.c_cap + n_calls;
      if (n_calls > 0 && ln.writes(0))
        a.call_len[c - 1] = n_pushed - cur_start;
      if (ln.writes(1)) a.call_x[c] = x;
      if (ln.writes(2)) a.call_start[c] = n_pushed;
      cur_start = n_pushed;
      ++n_calls;
      mpibwa::set_intv(a.fm, qx, ik0, ik1, ik2);
      info = x + 1;
      i = x + 1;
      kind = EXT;
    }
  }

  // Extend: push the interval where the read ends, at an ambiguous base or
  // where the extension changes its size; end the call there, or where
  // the size falls below min_intv; else take the extension.
  __device__ void step(const FwdArgs<P>& a, const Lane& ln, int len, P minv,
                       bool chain) {
    const int qi = ln.base(i);
    const bool at_end = i >= len;
    const bool amb = !at_end && qi > 3;
    const bool do_ext = !at_end && !amb;
    P nk0 = 0, nk1 = 0, ns = 0;
    if (do_ext)
      mpibwa::extend1_fwd<G>(a.fm, ik0, ik1, ik2, 3 - qi, ln.t, ln.mask, nk0,
                             nk1, ns);
    const bool changed = ns != ik2;
    if (at_end || amb || (do_ext && changed)) {
      if (n_pushed < a.f_cap) {
        const long long f = (long long)ln.b * a.f_cap + n_pushed;
        P* iv = a.ivals + 3 * f;
        if (ln.writes(0)) iv[0] = ik0;
        if (ln.writes(1)) iv[1] = ik1;
        if (ln.writes(2)) iv[2] = ik2;
        if (ln.writes(3)) a.infos[f] = info;
      } else {
        overflow = true;
      }
      ++n_pushed;
    }
    if (at_end || amb || (do_ext && changed && ns < minv)) {
      // the call returns its last push's end
      if (chain) { x = info; kind = SEEK; } else { kind = DONE; }
    } else {
      ik0 = nk0; ik1 = nk1; ik2 = ns;
      info = i + 1;
      i = i + 1;
    }
  }

  // the lane's counters and the length of the last call (the others were
  // closed as the next began)
  __device__ void finish(const FwdArgs<P>& a, const Lane& ln) {
    const int b = ln.b;
    if (n_calls > 0 && ln.writes(0))
      a.call_len[(long long)b * a.c_cap + n_calls - 1] = n_pushed - cur_start;
    if (ln.writes(1)) a.n_pushed[b] = n_pushed;
    if (ln.writes(2)) a.n_calls[b] = n_calls;
    if (ln.writes(3)) a.overflow[b] = overflow ? 1 : 0;
  }
};

// Pass 1 (chain) or pass 2 (one call from x0) of one lane to its end.
template <typename P>
__device__ __forceinline__ void run_fwd(const FwdArgs<P>& a, const Lane& ln,
                                        int x0, bool chain) {
  const int len = a.lens[ln.b];
  const P minv = a.minv[ln.b];
  Fwd<P> s;
  s.init(x0);
  while (s.kind != DONE) {
    if (s.kind == SEEK) s.seek(a, ln, len, chain);
    if (s.kind == EXT) s.step(a, ln, len, minv, chain);
  }
  s.finish(a, ln);
}

// Pass 3 of one lane to its end (bwt.c:358-379): from x, extend until the
// interval holds fewer than max_intv occurrences over at least
// min_seed_len bases, emit it (when it still occurs) and restart past its
// end.
template <typename P>
__device__ __forceinline__ void run_p3(const FwdArgs<P>& a,
                                       const P3Args<P>& p3, const Lane& ln) {
  const int len = a.lens[ln.b];
  const long long row = (long long)ln.b * p3.s3_cap;
  int x = 0, i = 0, kind = SEEK, n = 0;
  P k0 = 0, k1 = 0, k2 = 0;
  bool ov = false;
  while (kind != DONE) {
    if (kind == SEEK) {
      const int qx = ln.base(x);
      if (x >= len) {
        kind = DONE;
      } else if (qx > 3) {
        ++x;
      } else {
        mpibwa::set_intv(a.fm, qx, k0, k1, k2);
        i = x + 1;
        kind = EXT;
      }
    }
    if (kind != EXT) continue;
    const int qi = ln.base(i);
    const bool at_end = i >= len;
    const bool amb = !at_end && qi > 3;
    const bool do_ext = !at_end && !amb;
    P n0 = 0, n1 = 0, n2 = 0;
    if (do_ext)
      mpibwa::extend1_fwd<G>(a.fm, k0, k1, k2, 3 - qi, ln.t, ln.mask, n0, n1,
                             n2);
    const bool hit = do_ext && (long long)n2 < p3.max_intv
                     && i - x >= p3.min_seed_len;
    if (hit && n2 > 0) {
      if (n < p3.s3_cap) {
        P* sd = p3.seeds + 3 * (row + n);
        if (ln.writes(0)) sd[0] = n0;
        if (ln.writes(1)) sd[1] = n1;
        if (ln.writes(2)) sd[2] = n2;
        if (ln.writes(3))
          p3.infos[row + n] = ((long long)x << 32) | (long long)(i + 1);
      } else {
        ov = true;
      }
      ++n;
    }
    if (at_end) {
      kind = DONE;
    } else if (amb || hit) {
      x = i + 1;
      kind = SEEK;
    } else {
      k0 = n0; k1 = n1; k2 = n2;
      ++i;
    }
  }
  if (ln.writes(0)) p3.n_seeds[ln.b] = n;
  if (ln.writes(1)) p3.overflow[ln.b] = ov ? 1 : 0;
}

// reads a block: one group each, in each role
constexpr int PASS_READS = THREADS / G;
constexpr int P3_READS = THREADS / 2 / G;

template <typename P>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
forward_pass_kernel(FwdArgs<P> a, const int* starts, int chain,
                    long long Lp) {
  extern __shared__ int4 smem[];
  const int b0 = blockIdx.x * PASS_READS;
  const int off = Lp > 0 ? stage_reads(a.q, a.L, b0,
                                       min(PASS_READS, a.B - b0), smem)
                         : 0;
  const Lane ln = lane_of(a, b0, threadIdx.x, Lp, smem, off);
  if (ln.b >= a.B) return;
  run_fwd(a, ln, starts != nullptr ? starts[ln.b] : 0, chain != 0);
}

template <typename P>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
forward_p3_kernel(FwdArgs<P> a, P3Args<P> p3, long long Lp) {
  extern __shared__ int4 smem[];
  const int b0 = blockIdx.x * P3_READS;
  const int off = Lp > 0 ? stage_reads(a.q, a.L, b0,
                                       min(P3_READS, a.B - b0), smem)
                         : 0;
  // warps [0, 4) pass 1, warps [4, 8) pass 3, of the same reads
  const bool pass3 = threadIdx.x >= THREADS / 2;
  const Lane ln = lane_of(a, b0, threadIdx.x - (pass3 ? THREADS / 2 : 0), Lp,
                          smem, off);
  if (ln.b >= a.B) return;
  if (pass3) {
    run_p3(a, p3, ln);
  } else {
    run_fwd(a, ln, 0, true);
  }
}

template <typename P>
FwdArgs<P> fwd_args(const int2* o2, long long n_rows, const void* l2,
                    long long primary, long long seq_len,
                    const unsigned char* q, int B, long long L,
                    const int* lens, const void* minv, int f_cap, int c_cap,
                    void* ivals, int* infos, int* n_pushed, int* call_x,
                    int* call_start, int* call_len, int* n_calls,
                    unsigned char* overflow) {
  FwdArgs<P> a;
  a.fm.rows = o2;
  a.fm.n_rows = (P)n_rows;
  const long long* l2v = static_cast<const long long*>(l2);
  for (int c = 0; c < 5; ++c) a.fm.l2[c] = (P)l2v[c];
  a.fm.primary = (P)primary;
  a.fm.seq_len = (P)seq_len;
  a.q = q; a.B = B; a.L = L; a.lens = lens;
  a.minv = static_cast<const P*>(minv);
  a.f_cap = f_cap; a.c_cap = c_cap;
  a.ivals = static_cast<P*>(ivals); a.infos = infos; a.n_pushed = n_pushed;
  a.call_x = call_x; a.call_start = call_start; a.call_len = call_len;
  a.n_calls = n_calls; a.overflow = overflow;
  return a;
}

// A launch of blocks of `reads` reads: (grid, staged row width Lp, 0 when
// the rows are read in place, and the shared memory bytes).
struct Shape {
  unsigned grid;
  long long Lp;
  size_t smem;
};

Shape shape(int B, long long L, int reads) {
  const long long bytes = ((long long)reads * L + 31) / 16 * 16;
  Shape s;
  s.grid = (unsigned)((B + reads - 1) / reads);
  s.Lp = bytes <= STAGE_MAX ? L : 0;
  s.smem = s.Lp > 0 ? (size_t)bytes : 0;
  return s;
}

template <typename P>
int launch_pass(const FwdArgs<P>& a, const int* starts, int chain,
                cudaStream_t st) {
  const Shape s = shape(a.B, a.L, PASS_READS);
  forward_pass_kernel<P><<<s.grid, THREADS, s.smem, st>>>(a, starts, chain,
                                                          s.Lp);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_p3(const FwdArgs<P>& a, const P3Args<P>& p, cudaStream_t st) {
  const Shape s = shape(a.B, a.L, P3_READS);
  forward_p3_kernel<P><<<s.grid, THREADS, s.smem, st>>>(a, p, s.Lp);
  return (int)cudaGetLastError();
}

}  // namespace

// Host entry points. All pointers but `l2` are device pointers: `l2` is a
// host array of L2[0..4] as int64. wide = 1 selects the int64 position
// path (ivals, minv and seeds int64), 0 the int32 one. Outputs must be
// zero-filled. Each returns the cudaError of its launch (0 = launched);
// the launch goes to `stream` and does not synchronise.
extern "C" int mpibwa_forward_pass(
    int wide, const int2* o2, long long n_rows, const long long* l2,
    long long primary, long long seq_len, const unsigned char* q, int B,
    long long L, const int* lens, const void* minv, const int* starts,
    int chain, int f_cap, int c_cap, void* ivals, int* infos, int* n_pushed,
    int* call_x, int* call_start, int* call_len, int* n_calls,
    unsigned char* overflow, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch_pass(
        fwd_args<long long>(o2, n_rows, l2, primary, seq_len, q, B, L, lens,
                            minv, f_cap, c_cap, ivals, infos, n_pushed,
                            call_x, call_start, call_len, n_calls, overflow),
        starts, chain, st);
  return launch_pass(
      fwd_args<int>(o2, n_rows, l2, primary, seq_len, q, B, L, lens, minv,
                    f_cap, c_cap, ivals, infos, n_pushed, call_x, call_start,
                    call_len, n_calls, overflow),
      starts, chain, st);
}

extern "C" int mpibwa_forward_p3(
    int wide, const int2* o2, long long n_rows, const long long* l2,
    long long primary, long long seq_len, const unsigned char* q, int B,
    long long L, const int* lens, const void* minv, int f_cap, int c_cap,
    int s3_cap, int min_seed_len, long long max_intv, void* ivals,
    int* infos, int* n_pushed, int* call_x, int* call_start, int* call_len,
    int* n_calls, unsigned char* overflow, void* seeds, long long* seed_infos,
    int* n_seeds, unsigned char* p3_overflow, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch_p3(
        fwd_args<long long>(o2, n_rows, l2, primary, seq_len, q, B, L, lens,
                            minv, f_cap, c_cap, ivals, infos, n_pushed,
                            call_x, call_start, call_len, n_calls, overflow),
        P3Args<long long>{static_cast<long long*>(seeds), seed_infos, n_seeds,
                          p3_overflow, s3_cap, min_seed_len, max_intv},
        st);
  return launch_p3(
      fwd_args<int>(o2, n_rows, l2, primary, seq_len, q, B, L, lens, minv,
                    f_cap, c_cap, ivals, infos, n_pushed, call_x, call_start,
                    call_len, n_calls, overflow),
      P3Args<int>{static_cast<int*>(seeds), seed_infos, n_seeds, p3_overflow,
                  s3_cap, min_seed_len, max_intv},
      st);
}
