// Shared device functions of the block-layout FM kernels (occ4_extend.cu,
// bwd_pass.cu): bwt_occ4 over one fused 128-bp block row and the
// bwt_extend interval arithmetic (bwt.c:98-105, 165-186, 262-275).
//
// The fused table has one 48-byte row per 128 bases of the BWT:
// [occ[0..3] cumulative counts before the block, data[0..7] words of 16
// packed 2-bit bases, first base in the top bits]. A row is 16-byte aligned
// (48 = 3 x 16), so a thread reads it as three 16-byte loads through the
// read-only path.
//
// bwt_extend needs the counts at two positions, k-1 and k-1+s. extend4
// finds both block rows first and issues the loads of the distinct ones
// before any counting: one row (three loads) when both positions fall in
// one 128-bp block, as they do for most entries once intervals are narrow,
// two rows (six loads in flight together) otherwise, and nothing for a
// sentinel position.
#pragma once

#include <cuda_runtime.h>

namespace mpibwa {

struct FmConst {
  const int* blocks;  // (n_blocks, 12) int32 fused rows
  int n_blocks;
  int l2[4];    // L2[0..3]
  int primary;  // BWT position of the sentinel
};

struct Row {
  int4 occ, lo, hi;  // counts before the block; data words 0-3 and 4-7
};

__device__ __forceinline__ Row load_row(const FmConst& fm, int blk) {
  const int4* r = reinterpret_cast<const int4*>(fm.blocks) + 3 * (size_t)blk;
  return Row{__ldg(r), __ldg(r + 1), __ldg(r + 2)};
}

// A BWT position pos >= 0 as an offset into the stored bases: positions at
// or past `primary` shift down by one, since the sentinel is not stored.
__device__ __forceinline__ int stored(const FmConst& fm, int pos) {
  return pos - (pos >= fm.primary ? 1 : 0);
}

__device__ __forceinline__ int block_of(const FmConst& fm, int p) {
  return min(max(p >> 7, 0), fm.n_blocks - 1);
}

// cnt[c] = number of bases c in BWT[0..pos] (bwt_occ4) for the stored
// offset p of pos, from p's block row r.
__device__ __forceinline__ void count_row(const Row& r, int p, int cnt[4]) {
  const int within = p & 127;
  const unsigned words[8] = {(unsigned)r.lo.x, (unsigned)r.lo.y,
                             (unsigned)r.lo.z, (unsigned)r.lo.w,
                             (unsigned)r.hi.x, (unsigned)r.hi.y,
                             (unsigned)r.hi.z, (unsigned)r.hi.w};
  int c0 = r.occ.x, c1 = r.occ.y, c2 = r.occ.z, c3 = r.occ.w;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // bases of word j at or before `within`
    int nvalid = min(max(within + 1 - 16 * j, 0), 16);
    if (nvalid == 0) break;  // no later word holds a counted base
    // a shift by 32 is undefined: the full word takes its own mask
    unsigned mask = nvalid == 16 ? 0xFFFFFFFFu
                                 : ~((1u << (32 - 2 * nvalid)) - 1u);
    unsigned w = words[j] & mask, nw = ~w;
    // one bit per 2-bit base that equals c (__occ_aux), then popcount.
    // Masked-off bases read as 00, so base 0 takes back 16 - nvalid.
    c0 += __popc((nw >> 1) & nw & 0x55555555u) - (16 - nvalid);
    c1 += __popc((nw >> 1) & w & 0x55555555u);
    c2 += __popc((w >> 1) & nw & 0x55555555u);
    c3 += __popc((w >> 1) & w & 0x55555555u);
  }
  cnt[0] = c0; cnt[1] = c1; cnt[2] = c2; cnt[3] = c3;
}

// bwt_extend for all four bases. (k, l, s) is the bi-interval seen from the
// side being extended: k = x[!is_back] (the side whose ranks are taken),
// l = the other side, s = the size. Outputs per base c: ok_k[c], ok_l[c],
// ok_s[c]. Sums wrap as 32-bit two's complement (unsigned arithmetic), as
// the int32 tensors of the plain version do, so stale entries agree too.
// A position below 0 is the "before the first position" sentinel: it
// counts nothing and reads nothing.
__device__ __forceinline__ void extend4(const FmConst& fm, int k, int l, int s,
                                        int ok_k[4], int ok_l[4],
                                        int ok_s[4]) {
  const int kq = (int)((unsigned)k - 1u);
  const int kl = (int)((unsigned)kq + (unsigned)s);
  const int pk = stored(fm, kq), pl = stored(fm, kl);
  const int bk = block_of(fm, pk), bl = block_of(fm, pl);
  const bool has_k = kq >= 0, has_l = kl >= 0;
  const bool one = has_k && has_l && bk == bl;
  // every load before any count
  Row rk{}, rl{};
  if (has_k) rk = load_row(fm, bk);
  if (has_l && !one) rl = load_row(fm, bl);
  if (one) rl = rk;
  int tk[4] = {0, 0, 0, 0}, tl[4] = {0, 0, 0, 0};
  if (has_k) count_row(rk, pk, tk);
  if (has_l) count_row(rl, pl, tl);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    ok_s[c] = (int)((unsigned)tl[c] - (unsigned)tk[c]);
    ok_k[c] = (int)((unsigned)fm.l2[c] + 1u + (unsigned)tk[c]);
  }
  // the interval before extension spans the sentinel
  int hi = (int)((unsigned)k + (unsigned)s - 1u);
  unsigned add = (k <= fm.primary && hi >= fm.primary) ? 1u : 0u;
  unsigned o3 = (unsigned)l + add;
  unsigned o2 = o3 + (unsigned)ok_s[3];
  unsigned o1 = o2 + (unsigned)ok_s[2];
  unsigned o0 = o1 + (unsigned)ok_s[1];
  ok_l[0] = (int)o0; ok_l[1] = (int)o1; ok_l[2] = (int)o2; ok_l[3] = (int)o3;
}

}  // namespace mpibwa
