// Shared device functions of the kernels that walk the O2 table
// (fwd_automata.cu, sa_walk.cu): single-base ranks, the forward
// extension of one bi-interval by one base, set_intv and one step of the
// bwt_sa walk (bwt.c:86-96, 165-186, 262-275, 304-321).
//
// The O2 table (ops/backward8.build_o2) holds one 8-byte row [occ_c,
// packed_word] per 16-base sub-block sb and base c, at row sb * 4 + c: the
// four rows of a sub-block are one aligned 32-byte sector. A rank needs one
// row. The forward extension needs four ranks, of the base it extends by
// and of a second base for the forward correction, at two positions: a
// group of G threads (G = 1, 2 or 4) shares them, each thread loading the
// rows of its share (fwd_ranks), the group exchanging the ranks by
// shuffles; the rows of one position lie in one sector, so a group's loads
// touch one or two sectors. The SA walk reads one whole sector a step (two
// 16-byte loads through the read-only path): the base it reads and its
// rank both come from it (inv_psi; its edges take the plain step of two
// rows, inv_psi_edge). A row past either end of the table is taken at the
// index clamped into range, as the plain versions' gathers do, so any
// input gives their answer.
//
// Templated on the position type P: int for the int32 index, long long
// for the int64 one (force_wide, genomes of 2**31 positions or more). The
// sub-block and row arithmetic is in P too: on the int32 path a row index
// (under 2**29 for fewer than 2**31 positions) fits in 32 bits. Counts stay
// int32 either way. Sums wrap as two's complement (through the unsigned
// type), as the int tensors of the plain versions do.
#pragma once

#include <cuda_runtime.h>

namespace mpibwa {

template <typename P> struct Unsigned;
template <> struct Unsigned<int> { using T = unsigned; };
template <> struct Unsigned<long long> { using T = unsigned long long; };

template <typename P>
__device__ __forceinline__ P wadd(P a, P b) {
  using U = typename Unsigned<P>::T;
  return (P)((U)a + (U)b);
}

template <typename P>
__device__ __forceinline__ P wsub(P a, P b) {
  using U = typename Unsigned<P>::T;
  return (P)((U)a - (U)b);
}

template <typename P>
struct O2Fm {
  const int2* rows;  // (n_rows, 2) int32, 16-byte aligned
  P n_rows;          // a multiple of 4
  P l2[5];           // L2[0..4]
  P primary;         // BWT position of the sentinel
  P seq_len;
};

template <typename P>
__device__ __forceinline__ P clamp_row(P idx, P n) {
  return idx < 0 ? (P)0 : (idx > n - 1 ? n - 1 : idx);
}

template <typename P>
__device__ __forceinline__ P pick5(const P v[5], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : c == 3 ? v[3] : v[4];
}

// Occurrences of base c in the first within+1 bases of the MSB-first
// packed word, with the bwt.c:183-184 correction of the base-0 pad
// (ops/backward8._count_prefix).
__device__ __forceinline__ int count_prefix(int word, int c, int within) {
  const unsigned keep = ~((1u << (30 - 2 * within)) - 1u);
  const unsigned w = (unsigned)word & keep, nw = ~w;
  const unsigned a = ((c & 2) ? w : nw) >> 1;
  const unsigned b = (c & 1) ? w : nw;
  return __popc(a & b & 0x55555555u) - (c == 0 ? 15 - within : 0);
}

// A BWT position pos >= 0 as an offset into the stored bases: positions at
// or past `primary` shift down by one (the sentinel is not stored).
template <typename P>
__device__ __forceinline__ P stored(const O2Fm<P>& fm, P pos) {
  return pos - (pos >= fm.primary ? 1 : 0);
}

// Where a rank is taken: the stored offset (0 for the sentinel position
// below 0) and its sub-block.
template <typename P>
struct At {
  bool sent;
  P k;
  P sb;
};

template <typename P>
__device__ __forceinline__ At<P> at(const O2Fm<P>& fm, P pos) {
  At<P> a;
  a.sent = pos < 0;
  a.k = stored(fm, a.sent ? (P)0 : pos);
  a.sb = a.k >> 4;
  return a;
}

// rank of base c at a from its one row, loaded here (0 at the sentinel,
// no load)
template <typename P>
__device__ __forceinline__ int rank_at(const O2Fm<P>& fm, const At<P>& a,
                                       int c) {
  if (a.sent) return 0;
  const int2 row = __ldg(fm.rows + clamp_row(a.sb * 4 + c, fm.n_rows));
  return row.x + count_prefix(row.y, c, (int)(a.k & 15));
}

// set_intv (bwt.h): the bi-interval of the single base c (0..3)
template <typename P>
__device__ __forceinline__ void set_intv(const O2Fm<P>& fm, int c, P& k0,
                                         P& k1, P& s) {
  k0 = wadd(pick5(fm.l2, c), (P)1);
  s = wsub(pick5(fm.l2, c + 1), pick5(fm.l2, c));
  k1 = wadd(pick5(fm.l2, 3 - c), (P)1);
}

// The four ranks of a forward extension by cb: item j = 2 * pos + base,
// pos 0 at k, 1 at l, base 0 the base cb, 1 the extra base eb. Thread t of
// a group of G takes items t * 4/G .. t * 4/G + 4/G - 1, one row load and
// one rank each; the group then holds all four in r (every thread the
// same), by shuffles within the group's lanes `mask`. Every thread of the
// group must call this together.
template <int G, typename P>
__device__ __forceinline__ void fwd_ranks(const O2Fm<P>& fm, const At<P>& k,
                                          const At<P>& l, int cb, int t,
                                          unsigned mask, int r[4]) {
  constexpr int N = 4 / G;
  const int eb = cb == 1 ? 0 : 3;
  int mine[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int j = t * N + u;
    // field by field: a choice between the two structs themselves would
    // put them in local memory
    At<P> a;
    a.sent = (j & 2) ? l.sent : k.sent;
    a.k = (j & 2) ? l.k : k.k;
    a.sb = (j & 2) ? l.sb : k.sb;
    mine[u] = rank_at(fm, a, (j & 1) ? eb : cb);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (G == 1) {
      r[j] = mine[j];
    } else {
      r[j] = __shfl_sync(mask, mine[j % N], j / N, G);
    }
  }
}

// bwt.c's forward term of the other strand's start, from the rank of cb
// and of the extra base eb at one position (ops/fmd.extend1_fwd g_term)
template <typename P>
__device__ __forceinline__ P g_term(int cb, P tot, P occ_c, P occ_e) {
  return cb == 0 ? wsub(tot, occ_c)
       : cb == 1 ? wsub(wsub(tot, occ_e), occ_c)
       : cb == 2 ? occ_e : (P)0;
}

// Row cb (the complement of the base extended by) of bwt_extend(ik,
// is_back = 0) (ops/fmd.extend1_fwd), by a group of G threads (fwd_ranks):
// the ranks of cb and of the extra base eb that completes the cumulative
// count at both positions ik1 - 1 and ik1 - 1 + ik2, and the primary
// correction.
template <int G, typename P>
__device__ __forceinline__ void extend1_fwd(const O2Fm<P>& fm, P ik0, P ik1,
                                            P ik2, int cb, int t,
                                            unsigned mask, P& k0n, P& k1n,
                                            P& s2) {
  const P kq = wsub(ik1, (P)1);
  const At<P> k = at(fm, kq), l = at(fm, wadd(kq, ik2));
  int r[4];
  fwd_ranks<G>(fm, k, l, cb, t, mask, r);
  const int tkc = r[0], ek = r[1], tlc = r[2], el = r[3];
  // bases at or before the position, in stored offsets (0 at the sentinel)
  const P totk = k.sent ? (P)0 : wadd(k.k, (P)1);
  const P totl = l.sent ? (P)0 : wadd(l.k, (P)1);
  const P gk = g_term(cb, totk, (P)tkc, (P)ek);
  const P gl = g_term(cb, totl, (P)tlc, (P)el);
  s2 = (P)(int)((unsigned)tlc - (unsigned)tkc);
  k1n = wadd(wadd(pick5(fm.l2, cb), (P)1), (P)tkc);
  const P hi = wsub(wadd(ik1, ik2), (P)1);
  const P add = (ik1 <= fm.primary && hi >= fm.primary) ? (P)1 : (P)0;
  k0n = wadd(wadd(ik0, add), wsub(gl, gk));
}

// One step of the bwt_sa walk as the plain version takes it
// (ops/fmd._sa_lookup16): the base c of the BWT at x from row 0 of x's
// sub-block, its rank at k from row c of stored(k)'s sub-block (0 at the
// sentinel, k < 0), both rows clamped into the table; k == seq_len takes
// the rank from the L2 difference, k == primary steps to 0. Two dependent
// loads: inv_psi takes it only at these edges.
template <typename P>
__device__ __forceinline__ P inv_psi_edge(const O2Fm<P>& fm, P k, P x) {
  const int2 r0 = __ldg(fm.rows + clamp_row((x >> 4) * 4, fm.n_rows));
  const int c = (int)(((unsigned)r0.y >> (((~x) & 15) << 1)) & 3u);
  int occ = rank_at(fm, at(fm, k), c);
  if (k == fm.seq_len) occ = (int)wsub(pick5(fm.l2, c + 1), pick5(fm.l2, c));
  const P val = wadd(pick5(fm.l2, c), (P)occ);
  return k == fm.primary ? (P)0 : val;
}

// One step of the bwt_sa walk, k -> inv_psi(k) (bwt.c:86-96 through the O2
// table, ops/fmd._sa_lookup16), from one 32-byte sector load.
//
// The plain version takes the base c of the BWT at x = k - (k > primary)
// from row 0 of x's sub-block, then the rank of c at stored(k) = k - (k >=
// primary) from row c of stored(k)'s sub-block. For k >= 0 the two offsets
// differ only at k == primary. So for every k of the table but primary,
// seq_len and the sentinel (k < 0), the rank is taken from row c of x's
// own sector at x & 15, and the step loads that one sector; those three
// edges, and any index past the table, take the plain step
// (inv_psi_edge). tests/test_torch_fwd_kernel.py walks every index of two
// small indices, one with primary % 16 == 0, where stored(primary) lies
// in another sub-block.
//
// Before the load only the sector's address is worked out; the base's
// shift and the prefix mask, which depend on k alone, while it is in
// flight. After the load come only the base; its count in the prefix, by an XOR
// with the base repeated in every 2-bit field (11 where the base is c) and
// one masked popcount, which needs no correction of the pad; the picks of
// row c's count and of L2[c] by two-level select trees on the base; one
// add; and the next step's address. The count reads row 0's word: every
// row of a sub-block holds the same packed word (ops/backward8.build_o2).
template <typename P>
__device__ __forceinline__ P inv_psi(const O2Fm<P>& fm, P k) {
  using U = typename Unsigned<P>::T;
  const P x = k - (k > fm.primary ? 1 : 0);
  const P sb = x >> 4;
  if ((U)sb >= (U)(fm.n_rows >> 2) || k == fm.primary || k == fm.seq_len)
    return inv_psi_edge(fm, k, x);  // the sentinel (x < 0) lands here too
  const unsigned sh = (unsigned)((~x) & 15) << 1;  // the base's shift
  const unsigned keep = (0xFFFFFFFFu << sh) & 0x55555555u;  // bases 0..x&15
  const int4* p = reinterpret_cast<const int4*>(fm.rows) + 2 * sb;
  const int4 a = __ldg(p), b = __ldg(p + 1);  // rows 0, 1 | rows 2, 3
  const unsigned w = (unsigned)a.y;
  const int c = (int)((w >> sh) & 3u);
  const unsigned m = ~(w ^ (0x55555555u * (unsigned)c));
  const int occ = ((c & 2) ? ((c & 1) ? b.z : b.x) : ((c & 1) ? a.z : a.x))
                  + __popc(m & (m >> 1) & keep);
  const P l2c = (c & 2) ? ((c & 1) ? fm.l2[3] : fm.l2[2])
                        : ((c & 1) ? fm.l2[1] : fm.l2[0]);
  return wadd(l2c, (P)occ);
}

}  // namespace mpibwa
