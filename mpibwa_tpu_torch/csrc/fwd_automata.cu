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
// that is done no longer changes), so here each CUDA thread owns one read
// and runs its automata to their end: the same transitions in the same
// order, no launch a round, no host check.
//
// State in registers: pass 1's x, kind, bi-interval, info, i, counters and
// overflow flag; pass 3's x, i, kind, bi-interval, count and flag. A round
// of a lane: both automata seek (start a call at x, skip an ambiguous
// base, or finish), then both extend their interval forward by the base
// at i (csrc/o2.cuh: one 32-byte O2 sector a position, the sectors of both
// automata issued before either is used). Outputs are written straight
// into the plain version's arrays (FwdOut, Pass3Out), which the wrapper
// zero-fills: a push past F_CAP (a seed past S3_CAP) is counted and
// flagged, not written, and the lane runs on to its end, as in the JAX
// package; a call past C_CAP flags the lane and ends it.
//
// Bound: memory latency. A step's sectors depend on the interval the step
// before produced, so a lane waits about one device-memory latency a step,
// and the launch lasts about as long as its longest lane's steps; many
// lanes in flight (one thread each) hide the latency of the others. The
// bytes are small beside it: a 32-byte sector a position a step, the read
// once, and the outputs.
#include "o2.cuh"

namespace {

using mpibwa::O2Fm;
using mpibwa::wadd;

constexpr int SEEK = 0, EXT = 1, DONE = 2;
constexpr int THREADS = 64;

// Base of the read at pos, 4 outside its row (ops/seeding._query_at).
__device__ __forceinline__ int base_at(const unsigned char* q, long long L,
                                       int pos) {
  return (pos >= 0 && pos < L) ? (int)q[pos] : 4;
}

// the arrays of FwdOut, at the lane's rows
template <typename P>
struct FwdRows {
  P* ivals;          // (F_CAP, 3)
  int* infos;        // (F_CAP,)
  int* call_x;       // (C_CAP,)
  int* call_start;   // (C_CAP,)
  int* call_len;     // (C_CAP,)
};

// The pass-1/pass-2 automaton of one lane (ops/seeding._Fwd).
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
  __device__ void seek(const O2Fm<P>& fm, const unsigned char* q, long long L,
                       int len, bool chain, int c_cap,
                       const FwdRows<P>& o) {
    if (kind != SEEK) return;
    const int qx = base_at(q, L, x);
    if (x >= len) {
      kind = DONE;
    } else if (qx > 3) {
      if (chain) ++x; else kind = DONE;
    } else if (n_calls >= c_cap) {
      overflow = true;
      kind = DONE;
    } else {
      if (n_calls > 0) o.call_len[n_calls - 1] = n_pushed - cur_start;
      o.call_x[n_calls] = x;
      o.call_start[n_calls] = n_pushed;
      cur_start = n_pushed;
      ++n_calls;
      mpibwa::set_intv(fm, qx, ik0, ik1, ik2);
      info = x + 1;
      i = x + 1;
      kind = EXT;
    }
  }

  // Extend: push the interval where the read ends, at an ambiguous base or
  // where the extension changes its size; end the call there, or where
  // the size falls below min_intv; else take the extension.
  __device__ void step(const O2Fm<P>& fm, const mpibwa::FwdLoads<P>& f,
                       int qi, int len, P minv, bool chain, int f_cap,
                       const FwdRows<P>& o) {
    if (kind != EXT) return;
    const bool at_end = i >= len;
    const bool amb = !at_end && qi > 3;
    const bool do_ext = !at_end && !amb;
    P nk0 = 0, nk1 = 0, ns = 0;
    if (do_ext) mpibwa::extend1_fwd(fm, f, ik0, ik1, ik2, 3 - qi, nk0, nk1, ns);
    const bool changed = ns != ik2;
    const bool small = ns < minv;
    if (at_end || amb || (do_ext && changed)) {
      if (n_pushed < f_cap) {
        P* iv = o.ivals + 3 * (long long)n_pushed;
        iv[0] = ik0; iv[1] = ik1; iv[2] = ik2;
        o.infos[n_pushed] = info;
      } else {
        overflow = true;
      }
      ++n_pushed;
    }
    if (at_end || amb || (do_ext && changed && small)) {
      // the call returns its last push's end
      if (chain) { x = info; kind = SEEK; } else { kind = DONE; }
    } else {
      ik0 = nk0; ik1 = nk1; ik2 = ns;
      info = i + 1;
      i = i + 1;
    }
  }

  // the length of the last call (the others were closed as the next began)
  __device__ void finish(const FwdRows<P>& o, int* n_pushed_out,
                         int* n_calls_out, unsigned char* overflow_out) {
    if (n_calls > 0) o.call_len[n_calls - 1] = n_pushed - cur_start;
    *n_pushed_out = n_pushed;
    *n_calls_out = n_calls;
    *overflow_out = overflow ? 1 : 0;
  }
};

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

  __device__ FwdRows<P> rows(int b) const {
    const long long f = (long long)b * f_cap, c = (long long)b * c_cap;
    return FwdRows<P>{ivals + 3 * f, infos + f, call_x + c, call_start + c,
                      call_len + c};
  }
};

template <typename P>
__global__ void __launch_bounds__(THREADS)
forward_pass_kernel(FwdArgs<P> a, const int* starts, int chain) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= a.B) return;
  const unsigned char* q = a.q + (long long)b * a.L;
  const int len = a.lens[b];
  const P minv = a.minv[b];
  const FwdRows<P> o = a.rows(b);
  Fwd<P> s;
  s.init(starts != nullptr ? starts[b] : 0);
  while (s.kind != DONE) {
    s.seek(a.fm, q, a.L, len, chain != 0, a.c_cap, o);
    const int qi = base_at(q, a.L, s.i);
    const mpibwa::FwdLoads<P> f = mpibwa::extend1_fwd_load(a.fm, s.ik1, s.ik2);
    s.step(a.fm, f, qi, len, minv, chain != 0, a.f_cap, o);
  }
  s.finish(o, a.n_pushed + b, a.n_calls + b, a.overflow + b);
}

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

template <typename P>
__global__ void __launch_bounds__(THREADS)
forward_p3_kernel(FwdArgs<P> a, P3Args<P> p3) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= a.B) return;
  const unsigned char* q = a.q + (long long)b * a.L;
  const int len = a.lens[b];
  const P minv = a.minv[b];
  const FwdRows<P> o = a.rows(b);
  P* seeds = p3.seeds + 3 * (long long)b * p3.s3_cap;
  long long* sinfo = p3.infos + (long long)b * p3.s3_cap;
  Fwd<P> s;
  s.init(0);
  // pass 3 (bwt.c:358-379): from x, extend until the interval holds fewer
  // than max_intv occurrences over at least min_seed_len bases, emit it
  // (when it still occurs) and restart past its end
  int px = 0, pi = 0, pkind = SEEK, pn = 0;
  P pk0 = 0, pk1 = 0, pk2 = 0;
  bool pov = false;
  while (s.kind != DONE || pkind != DONE) {
    s.seek(a.fm, q, a.L, len, true, a.c_cap, o);
    if (pkind == SEEK) {
      const int pqx = base_at(q, a.L, px);
      if (px >= len) {
        pkind = DONE;
      } else if (pqx > 3) {
        ++px;
      } else {
        mpibwa::set_intv(a.fm, pqx, pk0, pk1, pk2);
        pi = px + 1;
        pkind = EXT;
      }
    }
    // both automata's reads and sectors before either is used
    const int qi = base_at(q, a.L, s.i);
    const int pqi = base_at(q, a.L, pi);
    const mpibwa::FwdLoads<P> f = mpibwa::extend1_fwd_load(a.fm, s.ik1, s.ik2);
    const mpibwa::FwdLoads<P> pf = mpibwa::extend1_fwd_load(a.fm, pk1, pk2);
    s.step(a.fm, f, qi, len, minv, true, a.f_cap, o);
    if (pkind == EXT) {
      const bool p_end = pi >= len;
      const bool pamb = !p_end && pqi > 3;
      const bool pdo = !p_end && !pamb;
      P q0 = 0, q1 = 0, q2 = 0;
      if (pdo) mpibwa::extend1_fwd(a.fm, pf, pk0, pk1, pk2, 3 - pqi, q0, q1, q2);
      const bool hit = pdo && (long long)q2 < p3.max_intv
                       && pi - px >= p3.min_seed_len;
      if (hit && q2 > 0) {
        if (pn < p3.s3_cap) {
          P* sd = seeds + 3 * (long long)pn;
          sd[0] = q0; sd[1] = q1; sd[2] = q2;
          sinfo[pn] = ((long long)px << 32) | (long long)(pi + 1);
        } else {
          pov = true;
        }
        ++pn;
      }
      if (p_end) {
        pkind = DONE;
      } else if (pamb || hit) {
        px = pi + 1;
        pkind = SEEK;
      } else {
        pk0 = q0; pk1 = q1; pk2 = q2;
        ++pi;
      }
    }
  }
  s.finish(o, a.n_pushed + b, a.n_calls + b, a.overflow + b);
  p3.n_seeds[b] = pn;
  p3.overflow[b] = pov ? 1 : 0;
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
  a.fm.n_rows = n_rows;
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

int grid(int B) { return (B + THREADS - 1) / THREADS; }

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
  if (wide) {
    auto a = fwd_args<long long>(o2, n_rows, l2, primary, seq_len, q, B, L,
                                 lens, minv, f_cap, c_cap, ivals, infos,
                                 n_pushed, call_x, call_start, call_len,
                                 n_calls, overflow);
    forward_pass_kernel<long long><<<grid(B), THREADS, 0, st>>>(a, starts,
                                                               chain);
  } else {
    auto a = fwd_args<int>(o2, n_rows, l2, primary, seq_len, q, B, L, lens,
                           minv, f_cap, c_cap, ivals, infos, n_pushed,
                           call_x, call_start, call_len, n_calls, overflow);
    forward_pass_kernel<int><<<grid(B), THREADS, 0, st>>>(a, starts, chain);
  }
  return (int)cudaGetLastError();
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
  if (wide) {
    auto a = fwd_args<long long>(o2, n_rows, l2, primary, seq_len, q, B, L,
                                 lens, minv, f_cap, c_cap, ivals, infos,
                                 n_pushed, call_x, call_start, call_len,
                                 n_calls, overflow);
    P3Args<long long> p{static_cast<long long*>(seeds), seed_infos, n_seeds,
                        p3_overflow, s3_cap, min_seed_len, max_intv};
    forward_p3_kernel<long long><<<grid(B), THREADS, 0, st>>>(a, p);
  } else {
    auto a = fwd_args<int>(o2, n_rows, l2, primary, seq_len, q, B, L, lens,
                           minv, f_cap, c_cap, ivals, infos, n_pushed,
                           call_x, call_start, call_len, n_calls, overflow);
    P3Args<int> p{static_cast<int*>(seeds), seed_infos, n_seeds, p3_overflow,
                  s3_cap, min_seed_len, max_intv};
    forward_p3_kernel<int><<<grid(B), THREADS, 0, st>>>(a, p);
  }
  return (int)cudaGetLastError();
}
