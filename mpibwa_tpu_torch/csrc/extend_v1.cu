// The first CUDA version of the banded seed extension (ksw_extend2,
// ksw.c:380-479), one thread per problem, kept only so that chip_smoke.py
// can time it against csrc/extend.cu in the same call on the same inputs.
// No path of the program launches it; chip_smoke.py binds its entry point
// mpibwa_extend_batch_v1 itself.
//
// One thread runs the scalar row recurrence of the spec
// (core/extend.py:46-146) over an eh scratch laid out [Q+1][B] in device
// memory, with the query and target windows transposed to [Q][B] and
// [T][B] by the caller, so the 32 threads of a warp touching column j hit
// 32 consecutive words. Every band cell waits on the one before it through
// F and hprev and on its own eh loads, and a launch of B problems holds
// only B / 32 warps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
extend_kernel(const uint8_t* __restrict__ qT, const uint8_t* __restrict__ tT,
              const int32_t* __restrict__ qlens,
              const int32_t* __restrict__ tlens,
              const int32_t* __restrict__ params,
              const int32_t* __restrict__ mat, int B, int Q, int T,
              int o_del, int e_del, int o_ins, int e_ins,
              int32_t* __restrict__ eh_h, int32_t* __restrict__ eh_e,
              int32_t* __restrict__ out) {
  __shared__ int32_t smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const size_t S = (size_t)B;  // stride between rows of every [.][B] array
  // qlen <= Q and tlen <= T hold for every caller (bucketed windows); the
  // clamp only keeps a malformed problem inside its own window.
  const int qlen = min(max(qlens[b], 0), Q);
  const int tlen = min(max(tlens[b], 0), T);
  int w = params[4 * b + 0];
  const int end_bonus = params[4 * b + 1];
  const int zdrop = params[4 * b + 2];
  const int h0 = params[4 * b + 3];
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  int32_t* H = eh_h + b;
  int32_t* E = eh_e + b;
  const uint8_t* q = qT + b;
  const uint8_t* t = tT + b;

  // first row (ksw.c:395-397)
  H[0] = h0;
  E[0] = 0;
  {
    int32_t v = h0 > oe_ins ? h0 - oe_ins : 0;
    bool chain = true;
    for (int j = 1; j <= qlen; ++j) {
      H[j * S] = chain ? v : 0;
      E[j * S] = 0;
      chain = chain && v > e_ins;
      v -= e_ins;
    }
  }

  // band clamp (ksw.c:399-407)
  int mmax = smat[0];
  for (int k = 1; k < 25; ++k) mmax = max(mmax, smat[k]);
  int max_ins =
      (int)(((double)qlen * mmax + end_bonus - o_ins) / e_ins + 1.0);
  max_ins = max(max_ins, 1);
  w = min(w, max_ins);
  int max_del =
      (int)(((double)qlen * mmax + end_bonus - o_del) / e_del + 1.0);
  max_del = max(max_del, 1);
  w = min(w, max_del);

  int maxv = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  int beg = 0, end = qlen;
  for (int i = 0; i < tlen; ++i) {
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    if (beg >= end) break;
    int32_t h1_first = 0;
    if (beg == 0) h1_first = max(h0 - (o_del + e_del * (i + 1)), 0);
    const int32_t* row = smat + 5 * t[i * S];
    int32_t f = 0;  // F[beg] = 0
    int32_t hprev = h1_first;
    int32_t mrun = 0;
    int mj = end - 1;
    for (int j = beg; j < end; ++j) {
      const size_t o = j * S;
      int32_t m = H[o];  // H(i-1, j-1)
      m = m != 0 ? m + row[q[o]] : 0;
      const int32_t e = E[o];
      int32_t h = max(max(m, e), f);
      H[o] = hprev;
      hprev = h;
      f = max(max(m - oe_ins, 0), f - e_ins);  // F[j+1]
      E[o] = max(max(m - oe_del, 0), e - e_del);
      if (h >= mrun) {
        mrun = h;
        mj = j;
      }
    }
    H[end * S] = hprev;
    E[end * S] = 0;
    const int32_t h1_last = hprev;  // H(i, end-1)
    if (end == qlen && gscore <= h1_last) {  // gscore at qlen (ksw.c:450-453)
      max_ie = i;
      gscore = max(gscore, h1_last);
    }
    if (mrun == 0) break;
    if (mrun > maxv) {
      maxv = mrun;
      max_i = i;
      max_j = mj;
      max_off = max(max_off, abs(mj - i));
    } else if (zdrop > 0) {  // z-drop (ksw.c:458-463)
      if (i - max_i > mj - max_j) {
        if (maxv - mrun - ((i - max_i) - (mj - max_j)) * e_del > zdrop) break;
      } else {
        if (maxv - mrun - ((mj - max_j) - (i - max_i)) * e_ins > zdrop) break;
      }
    }
    // band trimming over the updated eh arrays (ksw.c:466-469)
    int j = beg;
    while (j < end && H[j * S] == 0 && E[j * S] == 0) ++j;
    beg = j;
    j = end;
    while (j >= beg && H[j * S] == 0 && E[j * S] == 0) --j;
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  out[0 * S + b] = maxv;
  out[1 * S + b] = max_j + 1;
  out[2 * S + b] = max_i + 1;
  out[3 * S + b] = max_ie + 1;
  out[4 * S + b] = gscore;
  out[5 * S + b] = max_off;
}

}  // namespace

// qT (Q, B) and tT (T, B) uint8 nt4 codes (4 = pad/N); qlens, tlens (B,)
// int32; params (B, 4) int32 rows (w, end_bonus, zdrop, h0); mat (25,) int32
// row-major [target][query]; eh_h, eh_e (Q+1, B) int32 scratch; out (6, B)
// int32 rows (score, qle, tle, gtle, gscore, max_off). All pointers are
// device memory. Launches on `stream` and returns cudaGetLastError().
extern "C" int mpibwa_extend_batch_v1(const void* qT, const void* tT,
                                      const void* qlens, const void* tlens,
                                      const void* params, const void* mat,
                                      int B, int Q, int T, int o_del,
                                      int e_del, int o_ins, int e_ins,
                                      void* eh_h, void* eh_e, void* out,
                                      void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  extend_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)qT, (const uint8_t*)tT, (const int32_t*)qlens,
      (const int32_t*)tlens, (const int32_t*)params, (const int32_t*)mat, B,
      Q, T, o_del, e_del, o_ins, e_ins, (int32_t*)eh_h, (int32_t*)eh_e,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
