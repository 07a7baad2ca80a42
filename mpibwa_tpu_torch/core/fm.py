"""FM-index queries with exact reference semantics.

Scalar-exact implementation of the BWT rank/SA/SMEM machinery
(bwt.c). This module is the *spec engine*: the device
kernels in mpibwa_tpu_torch.ops are differential-tested against it, and it backs
the host fallback path.

Interval convention (bwtintv_t, bwt.h:60-63): x = (k, k', s) where k is the
SA-interval start on the forward BWT, k' the start on the reverse BWT, s the
interval size; info packs (start<<32 | end) query coordinates.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

SENTINEL = -1  # stands for (bwtint_t)(-1)


class FMIndex:
    """Array view of the interleaved occ/BWT structure (bwt.h:72-78)."""

    def __init__(self, primary: int, L2, seq_len: int, bwt: np.ndarray,
                 sa_intv: int, sa: np.ndarray):
        self.primary = int(primary)
        self.L2 = np.asarray(L2, dtype=np.int64)
        self.seq_len = int(seq_len)
        n_blocks = len(bwt) // 16
        blocks = np.ascontiguousarray(bwt[: n_blocks * 16]).reshape(n_blocks, 16)
        # occ counts: 4 little-endian u64 per block; values < 2^63 so int64 view is safe
        self.occ_blk = blocks[:, :8].copy().view(np.uint64).astype(np.int64)
        self.data = np.ascontiguousarray(blocks[:, 8:])  # (n_blocks, 8) u32
        self.sa_intv = int(sa_intv)
        self.sa = np.asarray(sa).view(np.int64)  # sa[0] == -1 sentinel
        # expanded bases per block for vectorized counting: (n_blocks, 128)
        shifts = np.arange(30, -2, -2, dtype=np.uint32)
        self.bases = ((self.data[:, :, None] >> shifts[None, None, :]) & np.uint32(3)) \
            .reshape(n_blocks, 128).astype(np.uint8)

    @classmethod
    def from_index(cls, idx) -> "FMIndex":
        return cls(idx.primary, idx.L2, idx.seq_len, idx.bwt, idx.sa_intv, idx.sa)

    # -- rank queries --------------------------------------------------------

    def occ4(self, k: int) -> np.ndarray:
        """Counts of each base in BWT[0..k] (bwt_occ4, bwt.c:169-186)."""
        if k == SENTINEL:
            return np.zeros(4, dtype=np.int64)
        if k >= self.primary:
            k -= 1
        blk, within = k >> 7, k & 127
        cnt = self.occ_blk[blk].copy()
        b = self.bases[blk, : within + 1]
        cnt += np.bincount(b, minlength=4).astype(np.int64)
        return cnt

    def occ4_batch(self, ks: np.ndarray) -> np.ndarray:
        """Vectorized occ4 over an int64 array of positions (−1 allowed)."""
        ks = np.asarray(ks, dtype=np.int64)
        sent = ks == SENTINEL
        k = np.where(sent, 0, ks)
        k = k - (k >= self.primary)
        blk, within = k >> 7, k & 127
        base = self.bases[blk]  # (n, 128)
        idx = np.arange(128, dtype=np.int64)[None, :]
        live = idx <= within[:, None]
        cnt = np.stack(
            [((base == c) & live).sum(axis=1) for c in range(4)], axis=1
        ).astype(np.int64)
        out = self.occ_blk[blk] + cnt
        out[sent] = 0
        return out

    def occ(self, k: int, c: int) -> int:
        """bwt_occ (bwt.c:107-129)."""
        if k == self.seq_len:
            return int(self.L2[c + 1] - self.L2[c])
        if k == SENTINEL:
            return 0
        return int(self.occ4(k)[c])

    def occ2_4(self, k: int, l: int) -> Tuple[np.ndarray, np.ndarray]:
        """bwt_2occ4 (bwt.c:189-220): same result as two occ4 calls."""
        return self.occ4(k), self.occ4(l)

    # -- suffix array --------------------------------------------------------

    def bwt_b0(self, k: int) -> int:
        """Base at position k of the $-removed BWT string (bwt_B0)."""
        return int(self.bases[k >> 7, k & 127])

    def inv_psi(self, k: int) -> int:
        """bwt_invPsi (bwt.c:53-59)."""
        x = k - (1 if k > self.primary else 0)
        x = self.bwt_b0(x)
        x = int(self.L2[x]) + self.occ(k, x)
        return 0 if k == self.primary else x

    def sa_lookup(self, k: int) -> int:
        """bwt_sa (bwt.c:86-96)."""
        sa, mask = 0, self.sa_intv - 1
        while k & mask:
            sa += 1
            k = self.inv_psi(k)
        return (sa + int(self.sa[k // self.sa_intv])) & 0xFFFFFFFFFFFFFFFF

    # -- bidirectional extension --------------------------------------------

    def set_intv(self, c: int):
        """bwt_set_intv (bwt.h:80): initial interval of single base c (<4)."""
        x0 = int(self.L2[c]) + 1
        x2 = int(self.L2[c + 1] - self.L2[c])
        x1 = int(self.L2[3 - c]) + 1
        return [x0, x1, x2]

    def extend(self, ik, is_back: int):
        """bwt_extend (bwt.c:262-275). ik/ok are [x0, x1, x2] lists.

        Returns ok[4] for the four bases.
        """
        fwd = 0 if is_back else 1  # index of x[!is_back]
        bwd = 1 - fwd
        tk = self.occ4(ik[fwd] - 1 if ik[fwd] - 1 >= 0 else SENTINEL)
        tl = self.occ4(ik[fwd] - 1 + ik[2])
        ok = [[0, 0, 0] for _ in range(4)]
        for i in range(4):
            ok[i][fwd] = int(self.L2[i]) + 1 + int(tk[i])
            ok[i][2] = int(tl[i] - tk[i])
        ok[3][bwd] = ik[bwd] + (
            1 if (ik[fwd] <= self.primary and ik[fwd] + ik[2] - 1 >= self.primary) else 0
        )
        ok[2][bwd] = ok[3][bwd] + ok[3][2]
        ok[1][bwd] = ok[2][bwd] + ok[2][2]
        ok[0][bwd] = ok[1][bwd] + ok[1][2]
        return ok

    # -- SMEM search ---------------------------------------------------------

    def smem1a(self, q: np.ndarray, x: int, min_intv: int, max_intv: int
               ) -> Tuple[int, List[Tuple[int, int, int, int]]]:
        """bwt_smem1a (bwt.c:289-351).

        q: uint8 query in nt4 coding; returns (next_x, mems) where each mem is
        (x0, x1, x2, info).
        """
        length = len(q)
        mems: List[Tuple[int, int, int, int]] = []
        if q[x] > 3:
            return x + 1, mems
        if min_intv < 1:
            min_intv = 1
        ik = self.set_intv(int(q[x]))
        ik_info = x + 1
        curr: List[Tuple[List[int], int]] = []
        i = x + 1
        while i < length:
            if max_intv and ik[2] < max_intv:  # unsigned compare: 0 max_intv never true
                curr.append((ik[:], ik_info))
                break
            elif q[i] < 4:
                c = 3 - int(q[i])
                ok = self.extend(ik, 0)
                if ok[c][2] != ik[2]:
                    curr.append((ik[:], ik_info))
                    if ok[c][2] < min_intv:
                        break
                ik = ok[c]
                ik_info = i + 1
            else:
                curr.append((ik[:], ik_info))
                break
            i += 1
        if i == length:
            curr.append((ik[:], ik_info))
        curr.reverse()
        ret = curr[0][1]
        prev = curr

        i = x - 1
        while i >= -1:
            c = -1 if i < 0 else (int(q[i]) if q[i] < 4 else -1)
            curr = []
            for p_x, p_info in prev:
                if c >= 0 and (not max_intv or ik[2] >= max_intv):
                    ok = self.extend(p_x, 1)
                else:
                    ok = None
                if c < 0 or (max_intv and ik[2] < max_intv) or (ok is not None and ok[c][2] < min_intv):
                    if not curr:
                        if not mems or i + 1 < (mems[-1][3] >> 32):
                            ik = p_x[:]
                            info = p_info | ((i + 1) << 32)
                            mems.append((ik[0], ik[1], ik[2], info))
                elif not curr or ok[c][2] != curr[-1][0][2]:
                    curr.append((ok[c][:], p_info))
            if not curr:
                break
            prev, curr = curr, prev
            i -= 1
        mems.reverse()
        return ret, mems

    def smem1(self, q: np.ndarray, x: int, min_intv: int):
        return self.smem1a(q, x, min_intv, 0)

    def seed_strategy1(self, q: np.ndarray, x: int, min_len: int, max_intv: int
                       ) -> Tuple[int, Optional[Tuple[int, int, int, int]]]:
        """bwt_seed_strategy1 (bwt.c:358-379): 3rd-round LAST-like seeding."""
        length = len(q)
        if q[x] > 3:
            return x + 1, None
        ik = self.set_intv(int(q[x]))
        i = x + 1
        while i < length:
            if q[i] < 4:
                c = 3 - int(q[i])
                ok = self.extend(ik, 0)
                if ok[c][2] < max_intv and i - x >= min_len:
                    mem = (ok[c][0], ok[c][1], ok[c][2], (x << 32) | (i + 1))
                    return i + 1, mem
                ik = ok[c]
            else:
                return i + 1, None
            i += 1
        return length, None
