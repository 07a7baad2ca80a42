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
// touch one or two sectors. The SA walk reads a whole sector a step
// (load_group: two 16-byte loads through the read-only path), the base it
// reads and its rank. A row past either end of the table is taken at the
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

// the four rows of a sub-block
struct Group {
  int2 r[4];
};

template <typename P>
__device__ __forceinline__ P clamp_row(P idx, P n) {
  return idx < 0 ? (P)0 : (idx > n - 1 ? n - 1 : idx);
}

template <typename P>
__device__ __forceinline__ Group load_group(const O2Fm<P>& fm, P sb) {
  const P base = sb * 4;
  Group g;
  if (base >= 0 && base + 3 < fm.n_rows) {
    const int4* p = reinterpret_cast<const int4*>(fm.rows + base);
    const int4 a = __ldg(p), b = __ldg(p + 1);
    g.r[0] = make_int2(a.x, a.y); g.r[1] = make_int2(a.z, a.w);
    g.r[2] = make_int2(b.x, b.y); g.r[3] = make_int2(b.z, b.w);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      g.r[j] = __ldg(fm.rows + clamp_row(base + j, fm.n_rows));
  }
  return g;
}

// g.r[c] without a dynamically indexed (local-memory) array
__device__ __forceinline__ int2 pick(const Group& g, int c) {
  return c == 0 ? g.r[0] : c == 1 ? g.r[1] : c == 2 ? g.r[2] : g.r[3];
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

// rank of base c at a from its sub-block's rows (0 at the sentinel)
template <typename P>
__device__ __forceinline__ int rank_in(const Group& g, const At<P>& a, int c) {
  if (a.sent) return 0;
  const int2 row = pick(g, c);
  return row.x + count_prefix(row.y, c, (int)(a.k & 15));
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

// One step of the bwt_sa walk, k -> inv_psi(k) (bwt.c:86-96 through the O2
// table, ops/fmd._sa_lookup16): the base of the BWT at k and its rank,
// from one sector (the base's row lies in the sector of its word unless k
// is the sentinel's own position, whose result is 0 anyway).
template <typename P>
__device__ __forceinline__ P inv_psi(const O2Fm<P>& fm, P k) {
  const P x = k - (k > fm.primary ? 1 : 0);
  const P sbx = x >> 4;
  const Group g = load_group(fm, sbx);
  const unsigned sh = (unsigned)((~x) & 15) << 1;
  const int c = (int)(((unsigned)g.r[0].y >> sh) & 3u);
  const At<P> a = at(fm, k);
  int occ;
  if (a.sent) {
    occ = 0;
  } else if (a.sb == sbx) {
    occ = rank_in(g, a, c);
  } else {  // another sector, or a clamped row
    const int2 row = __ldg(fm.rows + clamp_row(a.sb * 4 + c, fm.n_rows));
    occ = row.x + count_prefix(row.y, c, (int)(a.k & 15));
  }
  if (k == fm.seq_len)
    occ = (int)wsub(pick5(fm.l2, c + 1), pick5(fm.l2, c));
  const P val = wadd(pick5(fm.l2, c), (P)occ);
  return k == fm.primary ? (P)0 : val;
}

}  // namespace mpibwa
