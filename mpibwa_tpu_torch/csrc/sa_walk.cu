// The bwt_sa walk (bwt.c:86-96) of a batch of suffix-array indices in one
// launch, CUDA C++ for sm_90a.
//
// Replaces the device while_loop of mpibwa_tpu/ops/fmd.py `_sa_lookup16`
// (an XLA program, not a Pallas kernel). The JAX loop and the plain
// PyTorch version (ops/fmd._sa_lookup16) step every index in lockstep
// until the last one reaches a sampled row; an index that is done no
// longer moves, so here each CUDA thread owns one index and walks it to its
// end: k -> inv_psi(k) until k is a multiple of sa_intv, counting the
// steps, then the sampled position plus the steps. The edge rules are the
// plain version's (csrc/o2.cuh inv_psi), and sa[0] == -1 gives steps - 1
// (the C uint64 wraps to the same value).
//
// Bound. A walk has no parallelism inside it: each step reads one 32-byte
// O2 sector at the index the step before produced. Walk lengths are
// geometric (the SA is sampled at every sa_intv-th index), so a launch
// has two phases:
// - a heavy phase, with every walk in flight, held by the card's rate of
//   random sector loads (the random-load floor: the steps over that rate);
// - a latency tail, the last few hundred steps of a few walks, each step
//   one dependent device-memory load plus the step's own dependent path
//   (the latency floor: the longest walk's steps times one lone load).
// The tail sets the time. On the H100, on the main path's prefetch (N =
// 89,292 walks, 2,766,348 steps, the longest 356) with the L2 flushed
// before the launch, the 1% longest walks alone take 93% of the launch's
// time and the longest walk alone 78%, at 0.46 us a step against 0.375 us
// for a lone dependent load (PERF.md, kernel 6).
//
// Design. One thread a walk, every walk of the main path's prefetch
// resident at once (N = 89,292 is 698 blocks of 128 threads; at 2,048
// threads an SM the card holds 2,112), so the heavy phase keeps every load
// it can in flight. Since the tail is latency, the step is one sector load and the
// shortest dependent path after it (o2.cuh inv_psi): whatever depends on
// k alone is computed while the load is in flight, the rank comes from the
// same sector as the base, and the picks by the base are select trees,
// not chains. The heavy phase is a memory-rate phase and takes the extra
// instructions for free. On the int32 index, positions, rows and the step
// counter are 32-bit (the counter also caps an invalid index's walk at
// seq_len + 2 steps, which fits: the int32 index has seq_len + 2 <
// 2**31). The final gather sa[row] is one more dependent load, counted in
// the bound.
#include "o2.cuh"

namespace {

using mpibwa::O2Fm;

constexpr int THREADS = 128;

template <typename P>
__global__ void __launch_bounds__(THREADS)
sa_walk_kernel(O2Fm<P> fm, const P* __restrict__ sa, P n_sa, int log_intv,
               const P* __restrict__ ks, long long N, P* __restrict__ out) {
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const P mask = ((P)1 << log_intv) - 1;
  // a walk from a valid index ends within seq_len + 1 steps (its orbit
  // passes row 0); the cap only keeps an invalid index from spinning
  const P cap = mpibwa::wadd(fm.seq_len, (P)2);
  P k = ks[n], steps = 0;
  while ((k & mask) != 0 && steps < cap) {
    k = mpibwa::inv_psi(fm, k);
    ++steps;
  }
  P row = k >> log_intv;  // k // sa_intv (floor)
  row = row < 0 ? (P)0 : (row > n_sa - 1 ? n_sa - 1 : row);
  out[n] = mpibwa::wadd(steps, sa[row]);
}

template <typename P>
int launch(const int2* o2, long long n_rows, const long long* l2,
           long long primary, long long seq_len, const void* sa,
           long long n_sa, int log_intv, const void* ks, long long N,
           void* out, cudaStream_t st) {
  O2Fm<P> fm;
  fm.rows = o2;
  fm.n_rows = (P)n_rows;
  for (int c = 0; c < 5; ++c) fm.l2[c] = (P)l2[c];
  fm.primary = (P)primary;
  fm.seq_len = (P)seq_len;
  const long long grid = (N + THREADS - 1) / THREADS;
  sa_walk_kernel<P><<<(unsigned)grid, THREADS, 0, st>>>(
      fm, static_cast<const P*>(sa), (P)n_sa, log_intv,
      static_cast<const P*>(ks), N, static_cast<P*>(out));
  return (int)cudaGetLastError();
}

// A dependent-load probe for the walks' latency floor: each thread chases
// `steps` sectors of the O2 table, the next sector a hash of the row just
// loaded (so a load cannot issue before the one before it returns), and
// writes where it ended (so the loads are live). A step is one dependent
// device-memory load through the read-only path, as a walk's step, plus a
// few instructions of hashing.
__global__ void latency_probe_kernel(const int2* __restrict__ rows,
                                     unsigned n_sectors, int steps,
                                     unsigned seed, unsigned* out) {
  const unsigned id = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned s = (unsigned)(((unsigned long long)(seed ^ (id * 0x9E3779B9u))
                           * n_sectors) >> 32);
  for (int t = 0; t < steps; ++t) {
    const int2 r = __ldg(rows + 4ull * s);
    const unsigned h = ((unsigned)r.x * 0x9E3779B1u) ^ (unsigned)r.y
                       ^ (s * 0x85EBCA6Bu) ^ (unsigned)t;
    s = (unsigned)(((unsigned long long)h * n_sectors) >> 32);
  }
  out[id] = s;
}

}  // namespace

// The probe: `blocks` blocks of `threads` threads, each chasing `steps`
// sectors of the O2 table `o2` (n_rows rows, a multiple of 4; device
// pointer) from a start drawn from `seed`; out (blocks * threads) uint32
// on the device. Returns the cudaError of the launch.
extern "C" int mpibwa_latency_probe(const int2* o2, long long n_rows,
                                    int blocks, int threads, int steps,
                                    unsigned seed, unsigned* out,
                                    void* stream) {
  latency_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      o2, (unsigned)(n_rows / 4), steps, seed, out);
  return (int)cudaGetLastError();
}

// The device's L2 fetch granularity (cudaLimitMaxL2FetchGranularity, in
// bytes): its value before the call into *before, then set to `bytes`
// where bytes > 0. A measurement of the probe at another fetch size
// (chip_smoke.py phase 2g), which restores the value it read; nothing on
// the main path calls it. Returns the cudaError of the get or the set.
extern "C" int mpibwa_l2_fetch_granularity(long long bytes,
                                           long long* before) {
  size_t v = 0;
  cudaError_t e = cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity);
  if (e != cudaSuccess) return (int)e;
  *before = (long long)v;
  if (bytes > 0)
    e = cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
  return (int)e;
}

// Host entry point. All pointers but `l2` (a host array of L2[0..4] as
// int64) are device pointers; sa, ks and out hold positions of the index's
// type (wide = 1: int64, 0: int32). sa_intv = 1 << log_intv. Returns the
// cudaError of the launch (0 = launched); the launch goes to `stream` and
// does not synchronise.
extern "C" int mpibwa_sa_walk(int wide, const int2* o2, long long n_rows,
                              const long long* l2, long long primary,
                              long long seq_len, const void* sa,
                              long long n_sa, int log_intv, const void* ks,
                              long long N, void* out, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return wide ? launch<long long>(o2, n_rows, l2, primary, seq_len, sa, n_sa,
                                  log_intv, ks, N, out, st)
              : launch<int>(o2, n_rows, l2, primary, seq_len, sa, n_sa,
                            log_intv, ks, N, out, st);
}
