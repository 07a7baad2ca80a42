"""Per-chromosome SAM-line routing (mpiBWAByChr's write stage).

Routing rules (mainParallelByChromosome.c:1344-1458):
  - one output per contig, plus "discordant" and "unmapped"
    (with -f fixmate there is NO discordant output, incrmnt=1 :984-986)
  - RNAME '*' or unknown -> unmapped
  - without fixmate: RNEXT is inspected; '=' means same contig; when both
    the line's contig and its mate's contig are real and differ, the line is
    ALSO copied into discordant (:1448-1452)
Each output carries the FULL @SQ set in its header (parallel_aux.c:2677-87)
and, in BGZF/BAM mode, its own EOF magic (:1591-1599).
"""

from __future__ import annotations

from typing import Dict, List


class ByChrRouter:
    def __init__(self, anns, dofixmate: bool):
        self.names = [a.name for a in anns]
        self.n_seqs = len(self.names)
        self.dofixmate = dofixmate
        self.incrmnt = 1 if dofixmate else 2
        self.files = list(self.names)
        if not dofixmate:
            self.files.append("discordant")
        self.files.append("unmapped")
        self.nbchr = len(self.files)
        self.rid_of = {n: i for i, n in enumerate(self.names)}
        self.unmapped_idx = self.nbchr - 1
        self.disc_idx = self.n_seqs if not dofixmate else None

    def route_text(self, sam_text: str) -> Dict[int, List[str]]:
        """Returns file_idx -> list of lines (with newlines)."""
        out: Dict[int, List[str]] = {}

        def add(idx, line):
            out.setdefault(idx, []).append(line)

        for line in sam_text.splitlines(keepends=True):
            f = line.split("\t", 7)
            rname = f[2]
            chr_idx = self.rid_of.get(rname, self.n_seqs) \
                if rname != "*" else self.n_seqs
            dest = chr_idx if chr_idx < self.n_seqs else self.unmapped_idx
            add(dest, line)
            if not self.dofixmate and chr_idx < self.n_seqs:
                rnext = f[6]
                if rnext == "=":
                    mchr_idx = chr_idx
                elif rnext == "*":
                    mchr_idx = self.n_seqs
                else:
                    mchr_idx = self.rid_of.get(rnext, self.n_seqs)
                if mchr_idx < self.n_seqs and chr_idx != mchr_idx:
                    add(self.disc_idx, line)
        return out
