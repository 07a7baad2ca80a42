// Whole banded affine-gap seed extension (ksw_extend2, ksw.c:380-479) for a
// batch of independent problems, one warp per problem, row-parallel.
//
// Replaces the TPU kernel mpibwa_tpu/ops/pallas_extend.py:extend_batch_pallas.
// Like that kernel and the plain version (ops/extend_batch.py) it computes
// a DP row in parallel over the query: E(i+1, j) and F(i, j+1) both derive
// from M(i, j), which depends only on row i-1, so F is an exclusive decayed
// max scan of max(M - o_ins - e_ins, 0) along the row. The outputs are the
// exact ksw_extend2 outputs (spec core/extend.py:46) for any 5x5 matrix.
//
// What bounds it on an H100: operations, about 16 integer operations a band
// cell; a problem moves a few hundred bytes against thousands of cells.
// What the design does about it:
//   * one warp owns one problem. Lane L holds the eh slots (H and E) of the
//     C contiguous columns [L*C, L*C + C) in registers, C being the least of
//     1, 2, 3, 4, 5, 7, 9, 13, 17 that covers the problem's qlen + 1 slots
//     (a row's instructions grow with C, so a short query runs at a small
//     C); the kernel is instantiated for the largest C its window needs.
//     No DP state goes to device memory;
//   * a row is C cells of work a lane, a 5-step shuffle scan of the lane
//     aggregates for F, a warp max and a ballot for the row maximum (ties go
//     to the highest column, as `h >= mrun` does), a shift of H by one column
//     with one shuffle at each lane boundary, and two warp reductions for
//     the band trims, against a serial walk of the band by one thread;
//   * the query and target are read straight from their (B, Q) and (B, T)
//     rows: a lane loads its C query bases once, and 32 target bases at a
//     time into a register that a shuffle broadcasts row by row;
//   * a launch holds one warp per problem, 4 a block, so a few thousand
//     problems already fill the 132 SMs; warps take the problems from the
//     end of the batch, where the caller's sort puts the longest targets.
// Only the slots [beg, end] are written in a row, as in the scalar code:
// the rest keep their stale values, which a later row may read again.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// point and bound with ctypes (ops/extend_cuda.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // problems (warps) a block
constexpr unsigned kAll = 0xFFFFFFFFu;

struct Pen {
  int o_del, e_del, o_ins, e_ins;
};

struct Problem {
  const uint8_t* q;  // query row, Q bases
  const uint8_t* t;  // target row, T bases
  int T, qlen, tlen, w, end_bonus, zdrop, h0;
};

// ksw_extend2 of one problem on one warp, C columns a lane. Every lane
// returns the six outputs.
template <int C>
__device__ __forceinline__ void extend_warp(const Problem& pb,
                                            const int32_t* smat, Pen p,
                                            int lane, int32_t res[6]) {
  const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
  const int e_del = p.e_del, e_ins = p.e_ins;
  const int qlen = pb.qlen, h0 = pb.h0;
  const int j0 = lane * C;  // first column of this lane
  int H[C], E[C];
  unsigned qpk[(C + 3) / 4] = {};  // query bases, 4 to a word

  // first row (ksw.c:395-397): slot 0 = h0, slot 1 = max(h0 - oe_ins, 0),
  // then each slot e_ins below the one before while that one is > e_ins
  const int v1 = h0 > oe_ins ? h0 - oe_ins : 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    int hv = 0;
    if (j == 0) {
      hv = h0;
    } else if (j == 1) {
      hv = qlen >= 1 ? v1 : 0;
    } else if (j <= qlen) {
      // the chain reaches slot j iff every slot of 1..j-1 is > e_ins
      const int vprev = v1 - (j - 2) * e_ins;  // slot j-1
      const int vmin = e_ins > 0 ? vprev : v1;
      hv = vmin > e_ins ? vprev - e_ins : 0;
    }
    H[c] = hv;
    E[c] = 0;
    const unsigned qb = j < qlen ? pb.q[j] : 4u;
    qpk[c / 4] |= qb << (8 * (c % 4));
  }

  // band clamp (ksw.c:399-407)
  int mmax = smat[0];
  for (int k = 1; k < 25; ++k) mmax = max(mmax, smat[k]);
  int w = pb.w;
  int max_ins = (int)(((double)qlen * mmax + pb.end_bonus - p.o_ins) / e_ins +
                      1.0);
  max_ins = max(max_ins, 1);
  w = min(w, max_ins);
  int max_del = (int)(((double)qlen * mmax + pb.end_bonus - p.o_del) / e_del +
                      1.0);
  max_del = max(max_del, 1);
  w = min(w, max_del);

  int maxv = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  int beg = 0, end = qlen;
  int tchunk = 4;  // target bases i0 + lane of the current 32-row chunk
  for (int i = 0; i < pb.tlen; ++i) {
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    if (beg >= end) break;
    if ((i & 31) == 0) {
      const int ti = i + lane;
      tchunk = ti < pb.T ? pb.t[ti] : 4;
    }
    const int32_t* row = smat + 5 * __shfl_sync(kAll, tchunk, i & 31);
    const int h1_first =
        beg == 0 ? max(h0 - (p.o_del + e_del * (i + 1)), 0) : 0;

    // cells [beg, end): M from the slot; max(M, E) into the slot, E(i+1, j)
    // into E; g = the in-lane inclusive decayed max of max(M - oe_ins, 0)
    // (0 outside the band, which never changes F inside it)
    int g[C];
    int run = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      int tv = 0;
      if (j >= beg && j < end) {
        const int qb = (qpk[c / 4] >> (8 * (c % 4))) & 0xFF;
        const int m = H[c] != 0 ? H[c] + row[qb] : 0;
        tv = max(m - oe_ins, 0);
        H[c] = max(m, E[c]);
        E[c] = max(max(m - oe_del, 0), E[c] - e_del);
      }
      run = c == 0 ? tv : max(tv, run - e_ins);
      g[c] = run;
    }
    // the same scan over the lanes' aggregates, C columns of decay a lane;
    // pre = its value at column j0 - 1 (0 before column 0: F[beg] = 0)
    int s = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kAll, s, d);
      if (lane >= d) s = max(s, v - d * C * e_ins);
    }
    int pre = __shfl_up_sync(kAll, s, 1);
    if (lane == 0) pre = 0;

    // h(i, j) = max(M, E, F) with F(j) = the scan at column j - 1; the
    // lane's last column holding its largest h
    int best = -1, bj = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const int f = c == 0 ? pre : max(g[c > 0 ? c - 1 : 0], pre - c * e_ins);
      if (j >= beg && j < end) {
        H[c] = max(H[c], f);
        if (H[c] >= best) {
          best = H[c];
          bj = j;
        }
      }
    }
    // row maximum, ties to the highest column (the scalar loop's
    // `h >= mrun`); h >= 0 inside the band, so lanes without a band cell
    // (best -1) never match
    const int mrun = __reduce_max_sync(kAll, best);
    const int owner = 31 - __clz(__ballot_sync(kAll, best == mrun));
    const int mj = __shfl_sync(kAll, bj, owner);
    int hl = 0;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (j0 + c == end - 1) hl = H[c];
    const int h1_last = __shfl_sync(kAll, hl, (end - 1) / C);  // H(i, end-1)

    // slot j takes h(i, j-1) for j in (beg, end], slot beg h1_first; E of
    // slot end is 0
    const int left = __shfl_up_sync(kAll, H[C - 1], 1);
#pragma unroll
    for (int c = C - 1; c >= 0; --c) {
      const int j = j0 + c;
      const int prev = c == 0 ? left : H[c > 0 ? c - 1 : 0];
      if (j == beg) {
        H[c] = h1_first;
      } else if (j > beg && j <= end) {
        H[c] = prev;
      }
      if (j == end) E[c] = 0;
    }

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
    } else if (pb.zdrop > 0) {  // z-drop (ksw.c:458-463)
      if (i - max_i > mj - max_j) {
        if (maxv - mrun - ((i - max_i) - (mj - max_j)) * e_del > pb.zdrop)
          break;
      } else {
        if (maxv - mrun - ((mj - max_j) - (i - max_i)) * e_ins > pb.zdrop)
          break;
      }
    }
    // band trimming over the updated slots (ksw.c:466-469): beg = the first
    // nonzero slot of [beg, end), else end; end = 2 past the last nonzero
    // slot of [beg, end], else 1 past the new beg, capped at qlen
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      if ((H[c] | E[c]) != 0 && j >= beg && j <= end) {
        if (j < end) lo = min(lo, j);
        hi = j;
      }
    }
    lo = __reduce_min_sync(kAll, lo);
    hi = __reduce_max_sync(kAll, hi);
    beg = min(lo, end);
    const int last = hi >= beg ? hi : beg - 1;
    end = last + 2 < qlen ? last + 2 : qlen;
  }
  res[0] = maxv;
  res[1] = max_j + 1;
  res[2] = max_i + 1;
  res[3] = max_ie + 1;
  res[4] = gscore;
  res[5] = max_off;
}

// CMAX: the columns a lane needs for the window's Q + 1 slots (5, 9 or 17);
// each problem runs at the least C of its own qlen that the ladder has.
template <int CMAX>
__global__ void __launch_bounds__(32 * kWarps)
    extend_kernel(const uint8_t* __restrict__ qs,
                  const uint8_t* __restrict__ ts,
                  const int32_t* __restrict__ qlens,
                  const int32_t* __restrict__ tlens,
                  const int32_t* __restrict__ params,
                  const int32_t* __restrict__ mat, int B, int Q, int T, Pen p,
                  int32_t* __restrict__ out) {
  __shared__ int32_t smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // blocks start roughly in index order and callers sort problems by
  // target length, shortest first (pipeline/device_align.py), so warps take
  // problems from the end: the longest start first and the short ones fill
  // in behind them
  const int b = B - 1 - (blockIdx.x * kWarps + (threadIdx.x >> 5));
  if (b < 0) return;
  Problem pb;
  pb.q = qs + (size_t)b * Q;
  pb.t = ts + (size_t)b * T;
  pb.T = T;
  // qlen <= Q and tlen <= T hold for every caller (bucketed windows); the
  // clamp only keeps a malformed problem inside its own window
  pb.qlen = min(max(qlens[b], 0), Q);
  pb.tlen = min(max(tlens[b], 0), T);
  const int32_t* par = params + 4 * (size_t)b;
  pb.w = par[0];
  pb.end_bonus = par[1];
  pb.zdrop = par[2];
  pb.h0 = par[3];
  int32_t res[6];
  const int need = pb.qlen / 32 + 1;  // lanes cover slots 0..qlen
  if (need <= 1) {
    extend_warp<1>(pb, smat, p, lane, res);
  } else if (need <= 2) {
    extend_warp<2>(pb, smat, p, lane, res);
  } else if (need <= 3) {
    extend_warp<3>(pb, smat, p, lane, res);
  } else if (need <= 4) {
    extend_warp<4>(pb, smat, p, lane, res);
  } else if constexpr (CMAX == 5) {
    extend_warp<5>(pb, smat, p, lane, res);
  } else if (need <= 5) {
    extend_warp<5>(pb, smat, p, lane, res);
  } else if (need <= 7) {
    extend_warp<7>(pb, smat, p, lane, res);
  } else if constexpr (CMAX == 9) {
    extend_warp<9>(pb, smat, p, lane, res);
  } else if (need <= 9) {
    extend_warp<9>(pb, smat, p, lane, res);
  } else if (need <= 13) {
    extend_warp<13>(pb, smat, p, lane, res);
  } else {
    extend_warp<17>(pb, smat, p, lane, res);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) out[k * (size_t)B + b] = res[k];
  }
}

}  // namespace

// qs (B, Q) and ts (B, T) uint8 nt4 codes (4 = pad/N), Q <= 543; qlens,
// tlens (B,) int32; params (B, 4) int32 rows (w, end_bonus, zdrop, h0); mat
// (25,) int32 row-major [target][query]; out (6, B) int32 rows (score, qle,
// tle, gtle, gscore, max_off). All pointers are device memory. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int mpibwa_extend_batch(const void* qs, const void* ts,
                                   const void* qlens, const void* tlens,
                                   const void* params, const void* mat, int B,
                                   int Q, int T, int o_del, int e_del,
                                   int o_ins, int e_ins, void* out,
                                   void* stream) {
  if (B <= 0) return 0;
  const int need = Q / 32 + 1;
  if (Q < 0 || need > 17) return (int)cudaErrorInvalidValue;
  const Pen p{o_del, e_del, o_ins, e_ins};
  const int blocks = (B + kWarps - 1) / kWarps;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* q = (const uint8_t*)qs;
  const uint8_t* t = (const uint8_t*)ts;
  const int32_t* ql = (const int32_t*)qlens;
  const int32_t* tl = (const int32_t*)tlens;
  const int32_t* par = (const int32_t*)params;
  const int32_t* m = (const int32_t*)mat;
  int32_t* o = (int32_t*)out;
  if (need <= 5) {
    extend_kernel<5><<<blocks, 32 * kWarps, 0, st>>>(q, t, ql, tl, par, m, B,
                                                     Q, T, p, o);
  } else if (need <= 9) {
    extend_kernel<9><<<blocks, 32 * kWarps, 0, st>>>(q, t, ql, tl, par, m, B,
                                                     Q, T, p, o);
  } else {
    extend_kernel<17><<<blocks, 32 * kWarps, 0, st>>>(q, t, ql, tl, par, m,
                                                      B, Q, T, p, o);
  }
  return (int)cudaGetLastError();
}
