"""Reference coordinate/sequence helpers (bntseq.c semantics).

Positions live on the doubled forward+reverse coordinate system [0, 2*l_pac):
pos >= l_pac means the reverse strand (bns_depos, bntseq.h:87-90).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class RefSeq:
    def __init__(self, idx):
        self.l_pac = idx.l_pac
        self.anns = idx.anns
        self.n_seqs = len(idx.anns)
        from mpibwa_tpu_torch.index.format import unpack_pac

        # forward strand, uint8 0..3; the .tpumap path hands us a read-only
        # memmap so co-located shard processes share one physical copy
        ref_fwd = getattr(idx, "ref_fwd", None)
        self.ref = (ref_fwd if ref_fwd is not None
                    else unpack_pac(idx.pac, idx.l_pac))

    def depos(self, pos: int) -> Tuple[int, int]:
        """bns_depos: returns (forward_pos, is_rev)."""
        is_rev = 1 if pos >= self.l_pac else 0
        return ((self.l_pac << 1) - 1 - pos) if is_rev else pos, is_rev

    def pos2rid(self, pos_f: int) -> int:
        """bns_pos2rid (bntseq.c:349-363): binary search over contigs."""
        if pos_f >= self.l_pac:
            return -1
        left, mid, right = 0, 0, self.n_seqs
        while left < right:
            mid = (left + right) >> 1
            if pos_f >= self.anns[mid].offset:
                if mid == self.n_seqs - 1:
                    break
                if pos_f < self.anns[mid + 1].offset:
                    break
                left = mid + 1
            else:
                right = mid
        return mid

    def intv2rid(self, rb: int, re: int) -> int:
        """bns_intv2rid (bntseq.c:365-374)."""
        if rb < self.l_pac and re > self.l_pac:
            return -2
        assert rb <= re
        fb, _ = self.depos(rb)
        rid_b = self.pos2rid(fb)
        if rb < re:
            fe, _ = self.depos(re - 1)
            rid_e = self.pos2rid(fe)
        else:
            rid_e = rid_b
        return rid_b if rid_b == rid_e else -1

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """bns_get_seq (bntseq.c:398-419): bases over [beg,end) on the doubled
        coordinates; empty if bridging the strand boundary."""
        if end < beg:
            beg, end = end, beg
        if end > self.l_pac << 1:
            end = self.l_pac << 1
        if beg < 0:
            beg = 0
        if beg >= self.l_pac or end <= self.l_pac:
            if beg >= self.l_pac:  # reverse strand
                beg_f = (self.l_pac << 1) - end
                end_f = (self.l_pac << 1) - beg
                return (3 - self.ref[beg_f:end_f])[::-1].astype(np.uint8)
            return self.ref[beg:end].copy()
        return np.empty(0, dtype=np.uint8)

    def fetch_seq(self, beg: int, mid: int, end: int
                  ) -> Tuple[np.ndarray, int, int, int]:
        """bns_fetch_seq (bntseq.c:421-440): clamp [beg,end) to the contig
        containing mid; returns (seq, rid, beg', end')."""
        if end < beg:
            beg, end = end, beg
        assert beg <= mid < end
        fm, is_rev = self.depos(mid)
        rid = self.pos2rid(fm)
        far_beg = self.anns[rid].offset
        far_end = far_beg + self.anns[rid].length
        if is_rev:
            tmp = far_beg
            far_beg = (self.l_pac << 1) - far_end
            far_end = (self.l_pac << 1) - tmp
        beg = max(beg, far_beg)
        end = min(end, far_end)
        seq = self.get_seq(beg, end)
        assert len(seq) == end - beg
        return seq, rid, beg, end
