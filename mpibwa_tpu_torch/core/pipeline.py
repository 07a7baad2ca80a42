"""Batch alignment loops: the mem_process_seqs equivalent (host spec path).

worker1/worker2/mem_align1_core semantics (bwamem.c:1051-1234). The device
pipeline in mpibwa_tpu_torch.pipeline replaces the hot inner loops; this module is
the exact host reference and the finalization layer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from . import opts as O
from .chain import mem_chain, mem_chain_flt, mem_flt_chained_seeds
from .region import (AlnReg, mem_chain2aln, mem_mark_primary_se,
                     mem_reorder_primary5, mem_sort_dedup_patch)
from .sam import mem_reg2sam


@dataclasses.dataclass
class BSeq:
    """bseq1_t equivalent (bwa.h:49-56); seq holds nt4 codes."""

    name: str
    seq: np.ndarray
    qual: Optional[str] = None
    comment: Optional[str] = None
    sam: Optional[str] = None

    @property
    def l_seq(self) -> int:
        return len(self.seq)


def mem_align1_core(opt, fm, refs, q: np.ndarray, mem=None, sa=None,
                    extender=None) -> List[AlnReg]:
    """mem_align1_core (bwamem.c:1051-1087)."""
    l_seq = len(q)
    chn = mem_chain(opt, fm, refs, q, l_seq, mem=mem, sa=sa)
    chn = mem_chain_flt(opt, chn)
    mem_flt_chained_seeds(opt, refs, l_seq, q, chn)
    regs: List[AlnReg] = []
    for c in chn:
        mem_chain2aln(opt, refs, l_seq, q, c, regs, extender=extender)
    regs = mem_sort_dedup_patch(opt, refs, q, regs)
    for p in regs:
        if p.rid >= 0 and refs.anns[p.rid].is_alt:
            p.is_alt = 1
    return regs


def process_seqs(opt, fm, refs, seqs: List[BSeq], n_processed: int = 0,
                 pes0=None, rg_id: str = "") -> None:
    """mem_process_seqs (bwamem.c:1205-1234): fills seqs[i].sam in place."""
    n = len(seqs)
    if opt.flag & O.MEM_F_PE:
        from .pair import mem_pestat, mem_sam_pe

        regs = [mem_align1_core(opt, fm, refs, s.seq) for s in seqs]
        if pes0 is not None:
            pes = pes0
        else:
            pes = mem_pestat(opt, refs.l_pac, regs)
        for i in range(n >> 1):
            mem_sam_pe(opt, refs, pes, (n_processed >> 1) + i,
                       seqs[i << 1 : (i << 1) + 2], regs[i << 1 : (i << 1) + 2],
                       rg_id)
    else:
        for i, s in enumerate(seqs):
            regs = mem_align1_core(opt, fm, refs, s.seq)
            mem_mark_primary_se(opt, regs, n_processed + i)
            if opt.flag & O.MEM_F_PRIMARY5:
                mem_reorder_primary5(opt.T, regs)
            s.sam = mem_reg2sam(opt, refs, s, regs, 0, None, rg_id)
