"""Library API parity with the reference's extra entry points
(bwamem_extra.c): one-off alignment and the SMEM iterator, on the port's
host engines (core/, index/, io/); counterpart of mpibwa_tpu/api.py."""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Tuple

from mpibwa_tpu_torch.core.fm import FMIndex
from mpibwa_tpu_torch.core.opts import MemOpt, mem_opt_init
from mpibwa_tpu_torch.core.pipeline import mem_align1_core
from mpibwa_tpu_torch.core.refseq import RefSeq
from mpibwa_tpu_torch.core.region import AlnReg, mem_mark_primary_se
from mpibwa_tpu_torch.index.format import BwaIndex, load_index
from mpibwa_tpu_torch.io.fastq import encode_seq


class Aligner:
    """Convenience wrapper: index + engines + options."""

    def __init__(self, prefix_or_index, opt: Optional[MemOpt] = None):
        idx = (prefix_or_index if isinstance(prefix_or_index, BwaIndex)
               else load_index(prefix_or_index))
        self.idx = idx
        self.opt = opt or mem_opt_init()
        self.fm = FMIndex.from_index(idx)
        self.refs = RefSeq(idx)

    def align1(self, seq: str) -> List[AlnReg]:
        """mem_align1 (bwamem_extra.c:76-89): regions for one sequence with
        primary marking (the reference seeds the tie-break hash with
        lrand48; pass a fixed id here for reproducibility)."""
        q = encode_seq(seq)
        regs = mem_align1_core(self.opt, self.fm, self.refs, q)
        mem_mark_primary_se(self.opt, regs, random.getrandbits(31))
        return regs

    def smem_iter(self, seq: str, min_intv: int = 1, max_intv: int = 0
                  ) -> Iterator[List[Tuple[int, int, int, int]]]:
        """smem_next (bwamem_extra.c:60-71): yields, per start position, the
        SMEMs covering it as (x0, x1, x2, info) tuples."""
        q = encode_seq(seq)
        start = 0
        n = len(q)
        while start < n:
            while start < n and q[start] > 3:
                start += 1
            if start == n:
                return
            start, mems = self.fm.smem1a(q, start, min_intv, max_intv)
            yield mems
