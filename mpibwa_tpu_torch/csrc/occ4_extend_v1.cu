// The first CUDA version of the fused bwt_occ4 + bidirectional bwt_extend
// for all four bases, kept only so that chip_smoke.py can time it against
// csrc/occ4_extend.cu in the same call on the same inputs. No path of the
// program launches it; chip_smoke.py binds its entry point
// mpibwa_occ4_extend_v1 itself. The shared block code of that version
// (csrc/occ4.cuh as it was) is inlined below.
//
// One thread owns one entry: two bwt_occ4 calls, each reading its own
// 48-byte block row (three 16-byte loads) and counting it before the next
// row is read, then the bwt_extend arithmetic; the (4, 3) output is
// written as twelve 4-byte stores.
#include <cuda_runtime.h>

namespace v1 {

struct FmConst {
  const int* blocks;  // (n_blocks, 12) int32 fused rows
  int n_blocks;
  int l2[4];    // L2[0..3]
  int primary;  // BWT position of the sentinel
};

// cnt[c] = number of bases c in BWT[0..pos] (bwt_occ4); pos < 0 is the
// "before the first position" sentinel and counts nothing. Positions at or
// past `primary` shift down by one: the sentinel is not stored.
__device__ __forceinline__ void occ4(const FmConst& fm, int pos, int cnt[4]) {
  if (pos < 0) {
    cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
    return;
  }
  int p = pos - (pos >= fm.primary ? 1 : 0);
  int blk = min(max(p >> 7, 0), fm.n_blocks - 1);
  int within = p & 127;
  const int4* row = reinterpret_cast<const int4*>(fm.blocks) + 3 * (size_t)blk;
  int4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
  unsigned words[8] = {(unsigned)r1.x, (unsigned)r1.y, (unsigned)r1.z,
                       (unsigned)r1.w, (unsigned)r2.x, (unsigned)r2.y,
                       (unsigned)r2.z, (unsigned)r2.w};
  int c0 = r0.x, c1 = r0.y, c2 = r0.z, c3 = r0.w;
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
__device__ __forceinline__ void extend4(const FmConst& fm, int k, int l, int s,
                                        int ok_k[4], int ok_l[4],
                                        int ok_s[4]) {
  int tk[4], tl[4];
  int kq = (int)((unsigned)k - 1u);
  occ4(fm, kq, tk);
  occ4(fm, (int)((unsigned)kq + (unsigned)s), tl);
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

}  // namespace v1

namespace {

__global__ void occ4_extend_kernel(v1::FmConst fm,
                                   const int* __restrict__ ik,  // (E, 3)
                                   int E, int is_back,
                                   int* __restrict__ out) {  // (E, 4, 3)
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  int x0 = ik[3 * e], x1 = ik[3 * e + 1], x2 = ik[3 * e + 2];
  int ok_k[4], ok_l[4], ok_s[4];
  // backward extension ranks x[0], forward extension ranks x[1]
  v1::extend4(fm, is_back ? x0 : x1, is_back ? x1 : x0, x2, ok_k, ok_l, ok_s);
  int* o = out + 12 * (size_t)e;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    o[3 * c + 0] = is_back ? ok_k[c] : ok_l[c];
    o[3 * c + 1] = is_back ? ok_l[c] : ok_k[c];
    o[3 * c + 2] = ok_s[c];
  }
}

}  // namespace

// Returns the cudaError of the launch (0 = launched). All pointers are
// device pointers; the launch goes to `stream` and does not synchronise.
extern "C" int mpibwa_occ4_extend_v1(const int* blocks, int n_blocks,
                                     int l2_0, int l2_1, int l2_2, int l2_3,
                                     int primary, const int* ik, int E,
                                     int is_back, int* out, void* stream) {
  if (E <= 0) return 0;
  v1::FmConst fm{blocks, n_blocks, {l2_0, l2_1, l2_2, l2_3}, primary};
  const int threads = 256;
  int grid = (E + threads - 1) / threads;
  occ4_extend_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      fm, ik, E, is_back, out);
  return (int)cudaGetLastError();
}
