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
// plain version's: k == primary steps to 0, k == seq_len takes its rank
// from the L2 difference, and sa[0] == -1 gives steps - 1 (the C uint64
// wraps to the same value).
//
// Bound: memory latency. Each step reads one 32-byte O2 sector
// (csrc/o2.cuh) at the index the step before produced, so an index waits
// about one device-memory latency a step, and the launch lasts about as
// long as its longest walk (fewer than sa_intv steps on a real index);
// the bytes are a sector a step, the index and the result.
#include "o2.cuh"

namespace {

using mpibwa::O2Fm;

constexpr int THREADS = 128;

template <typename P>
__global__ void __launch_bounds__(THREADS)
sa_walk_kernel(O2Fm<P> fm, const P* __restrict__ sa, long long n_sa,
               int log_intv, const P* __restrict__ ks, long long N, P* out) {
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const P mask = ((P)1 << log_intv) - 1;
  P k = ks[n], steps = 0;
  // a walk from a valid index ends within seq_len + 1 steps (its orbit
  // passes row 0); the cap only keeps an invalid index from spinning
  const long long cap = (long long)fm.seq_len + 2;
  for (long long t = 0; (k & mask) != 0 && t < cap; ++t) {
    k = mpibwa::inv_psi(fm, k);
    steps = mpibwa::wadd(steps, (P)1);
  }
  long long row = (long long)(k >> log_intv);  // k // sa_intv (floor)
  row = row < 0 ? 0 : (row > n_sa - 1 ? n_sa - 1 : row);
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
      fm, static_cast<const P*>(sa), n_sa, log_intv,
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
