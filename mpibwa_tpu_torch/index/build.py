"""Index construction from FASTA (the `bwa index` + mpiBWAIdx offline path).

Produces the same on-disk artifacts a bwa-0.7.17 `bwa index` run yields
(.pac/.ann/.amb byte-identical including the lrand48 hole filling; .bwt/.sa
byte-identical because the BWT of the forward+reverse packed sequence and
the sampled suffix array are canonical), then packs them into the flat device
image (pidx.c equivalent).

Formats: bns_fasta2bntseq (bntseq.c:220-327),
bwt dump (bwt.c:385-407), sampling bwt_cal_sa
(bwt.c:62-84).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .format import (OCC_INTERVAL, AmbHole, BwaIndex, ContigAnn, NT4_TABLE)


class LRand48:
    """Exact drand48-family LCG (POSIX): x' = (a*x + c) mod 2^48."""

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def lrand48(self) -> int:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x >> 17


def _lrand48_fill(rng: "LRand48", n: int) -> np.ndarray:
    """n sequential lrand48()&3 draws, advancing rng's state; native C
    when available (150M draws for GRCh38's N bases are Python-loop bound
    otherwise)."""
    from mpibwa_tpu_torch.native import lrand48_fill_native

    out = lrand48_fill_native(rng, n)
    if out is not None:
        return out
    return np.array([rng.lrand48() & 3 for _ in range(n)], np.uint8)


def parse_fasta(path: str):
    """Yields (name, comment, seq_str)."""
    name = comment = None
    chunks: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, comment, "".join(chunks)
                head = line[1:].split(None, 1)
                name = head[0]
                comment = head[1] if len(head) > 1 else ""
                chunks = []
            else:
                chunks.append(line.strip())
    if name is not None:
        yield name, comment, "".join(chunks)


def fasta2bnt(path: str) -> Tuple[List[ContigAnn], List[AmbHole], np.ndarray, int]:
    """bns_fasta2bntseq equivalent: contig table, holes, 2-bit pac, l_pac.

    N (and any non-ACGT) bases become lrand48()%4 with seed 11
    (bntseq.c: bns->seed = 11, srand48(bns->seed))."""
    rng = LRand48(11)
    anns: List[ContigAnn] = []
    ambs: List[AmbHole] = []
    bases: List[np.ndarray] = []
    l_pac = 0
    for name, comment, seq in parse_fasta(path):
        offset = l_pac
        raw = np.frombuffer(seq.encode(), dtype=np.uint8)
        codes = NT4_TABLE[raw].copy()
        amb_idx = np.nonzero(codes > 3)[0]
        if len(amb_idx):
            # ambiguity holes = maximal runs of the SAME ambiguous
            # character (bns_fasta2bntseq semantics). Vectorized: a new
            # hole starts where the ambiguous positions are non-adjacent
            # or the character changes — a GRCh38 chromosome would take
            # minutes per contig through the per-character Python loop
            # this replaces (verified identical by the oracle-diffed
            # genome-scale build test, whose genome contains N runs).
            chars = raw[amb_idx]
            new_run = np.ones(len(amb_idx), bool)
            new_run[1:] = (np.diff(amb_idx) != 1) | (chars[1:] != chars[:-1])
            starts = np.nonzero(new_run)[0]
            run_len = np.diff(np.append(starts, len(amb_idx)))
            for s, ln in zip(starts, run_len):
                ambs.append(AmbHole(offset + int(amb_idx[s]), int(ln),
                                    chr(chars[s])))
            # lrand48()%4 per ambiguous base IN ORDER (the LCG state is
            # sequential); drawn natively when the C library is present
            codes[amb_idx] = _lrand48_fill(rng, len(amb_idx))
            n_ambs = len(starts)
        else:
            n_ambs = 0
        anns.append(ContigAnn(offset, len(seq), n_ambs, 0, 0, name, comment or ""))
        bases.append(codes)
        l_pac += len(seq)
    allb = np.concatenate(bases) if bases else np.zeros(0, np.uint8)
    # pack 2-bit MSB-first, 4/byte
    pad = (-l_pac) % 4
    padded = np.concatenate([allb, np.zeros(pad, np.uint8)])
    quads = padded.reshape(-1, 4)
    pac = ((quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2)
           | quads[:, 3]).astype(np.uint8)
    return anns, ambs, pac, l_pac


def suffix_array(s: np.ndarray) -> np.ndarray:
    """SA of s with an implicit smallest sentinel at the end (prefix-doubling,
    O(n log^2 n) with numpy sorts)."""
    n = len(s)
    rank = s.astype(np.int64) + 1  # sentinel rank 0 reserved
    sa = np.arange(n, dtype=np.int64)
    tmp = np.zeros(n, dtype=np.int64)
    k = 1
    while True:
        # past-end key must sort below EVERY group id; group ids start at 0
        # after the first round, so 0 here would tie with the smallest
        # suffix's group and never converge (hang) — use -1
        key2 = np.full(n, -1, dtype=np.int64)
        idx = np.arange(n) + k
        valid = idx < n
        key2[valid] = rank[idx[valid]]
        order = np.lexsort((key2, rank))
        sa = order
        tmp[sa[0]] = 0
        prev_r = rank[sa[:-1]]
        prev_r2 = key2[sa[:-1]]
        cur_r = rank[sa[1:]]
        cur_r2 = key2[sa[1:]]
        newgrp = (cur_r != prev_r) | (cur_r2 != prev_r2)
        tmp[sa[1:]] = np.cumsum(newgrp)
        rank = tmp.copy()
        if rank[sa[-1]] == n - 1:
            break
        k <<= 1
    return sa


def build_fmindex(pac: np.ndarray, l_pac: int, sa_intv: int = 32):
    """BWT + occ-interleaved array + sampled SA of forward+reverse sequence."""
    from .format import unpack_pac

    fwd = unpack_pac(pac, l_pac)
    seq = np.concatenate([fwd, (3 - fwd)[::-1]])  # forward + reverse complement
    n = len(seq)  # == seq_len
    # native SA-IS (O(n), genome-scale); numpy prefix doubling as fallback
    from mpibwa_tpu_torch.native import sais_u8

    sa_native = sais_u8(seq)
    sa_full = (sa_native.astype(np.int64) if sa_native is not None
               else suffix_array(seq))
    # bwa's SA convention: rank 0 is the sentinel suffix ($); bwt_sa(k) for
    # k>=1 equals sa_full[k-1] ... with primary = rank of suffix 0 + 1
    # Reconstruct the C layout directly:
    #   The BWT string (with $ removed) has length n; entry for rank k (over
    #   n+1 ranks incl. $ at rank 0... the C bwt stores n chars with primary
    #   marking the $ position.
    # C semantics: SA over suffixes of seq; $-suffix sorts first (rank 0).
    # For rank r in [0, n]: suffix = n if r == 0 else sa_full[r-1].
    # bwt[r] = seq[suffix-1] for suffix > 0; at suffix == 0 -> primary = r.
    suffixes = np.concatenate([[n], sa_full])  # rank -> suffix start
    del sa_full  # Gbp-scale: drop the 8n-byte duplicate before the gathers
    primary = int(np.nonzero(suffixes == 0)[0][0])
    # packed bwt skips the $ (primary) entry (slice instead of a boolean
    # arange mask: the mask costs another 9n bytes at Gbp scale)
    sfx = np.empty(n, dtype=suffixes.dtype)
    sfx[:primary] = suffixes[:primary]
    sfx[primary:] = suffixes[primary + 1 :]
    sfx -= 1
    bwt_chars = seq[sfx]
    del sfx
    # cumulative counts L2
    cnt = np.bincount(seq, minlength=4).astype(np.int64)
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(cnt)
    # interleaved occ blocks
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    padded = np.concatenate([bwt_chars, np.zeros(n_blocks * OCC_INTERVAL - n,
                                                 np.uint8)])
    per_block = padded.reshape(n_blocks, OCC_INTERVAL)
    blk_cnt = np.zeros((n_blocks, 4), dtype=np.uint64)
    for c in range(4):
        blk_cnt[:, c] = (per_block == c).sum(axis=1)
    occ_cum = np.zeros((n_blocks, 4), dtype=np.uint64)
    occ_cum[1:] = np.cumsum(blk_cnt, axis=0)[:-1]
    # pack 2-bit data words (16 bases / u32, MSB-first)
    shifts = np.arange(30, -2, -2, dtype=np.uint32)
    words = (per_block.reshape(n_blocks, 8, 16).astype(np.uint32)
             << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)
    inter = np.zeros((n_blocks, 16), dtype=np.uint32)
    inter[:, :8] = occ_cum.view(np.uint32).reshape(n_blocks, 8)
    inter[:, 8:] = words
    # bwa's on-disk layout: per block an occ record + its data words (the
    # last block has only ceil(partial/16) words), then ONE trailing occ
    # record holding the totals (bwt_bwtupdate_core appends it; queries
    # never read it but file parity requires it).
    n_data_words = (n + 15) // 16
    totals = np.bincount(bwt_chars, minlength=4).astype(np.uint64)
    if n_data_words == n_blocks * 8:
        # every block full (n % 128 == 0): the interleaved array IS the
        # file layout — avoids the per-block Python list (Gbp genomes
        # have tens of millions of blocks)
        bwt_arr = np.concatenate([inter.reshape(-1),
                                  totals.view(np.uint32)])
    else:
        flat = []
        for b in range(n_blocks):
            flat.append(inter[b, :8])
            lo = b * 8
            hi = min((b + 1) * 8, n_data_words)
            flat.append(inter[b, 8 : 8 + (hi - lo)])
        flat.append(totals.view(np.uint32))
        bwt_arr = np.concatenate(flat).astype(np.uint32)
    # sampled SA with bwt_cal_sa semantics: sa[r/intv] = SA value of rank r
    # where bwt_sa(r) = (r==0 ? n : suffix) ... C: isa=0,sa=seq_len; walk.
    # Equivalently: sampled[r//intv] = (suffixes[r]) with sa[0] = -1.
    n_sa = (n + sa_intv) // sa_intv
    samp = np.zeros(n_sa, dtype=np.uint64)
    ranks = np.arange(0, n + 1, sa_intv)
    samp[: len(ranks)] = suffixes[ranks].astype(np.uint64)
    samp[0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return int(primary), L2, n, bwt_arr, sa_intv, samp


def write_bwt_file(path: str, primary: int, L2: np.ndarray, bwt_arr: np.ndarray):
    with open(path, "wb") as f:
        np.asarray([primary], dtype=np.uint64).tofile(f)
        np.asarray(L2[1:5], dtype=np.uint64).tofile(f)
        bwt_arr.astype(np.uint32).tofile(f)


def write_sa_file(path: str, primary: int, L2: np.ndarray, sa_intv: int,
                  seq_len: int, samp: np.ndarray):
    with open(path, "wb") as f:
        np.asarray([primary], dtype=np.uint64).tofile(f)
        np.asarray(L2[1:5], dtype=np.uint64).tofile(f)
        np.asarray([sa_intv, seq_len], dtype=np.uint64).tofile(f)
        samp[1:].astype(np.uint64).tofile(f)


def write_pac_file(path: str, pac: np.ndarray, l_pac: int):
    """bns_fasta2bntseq's pac dump: packed bytes, then if l_pac%4==0 an extra
    zero byte, then one byte holding l_pac%4 (bntseq.c:311-320)."""
    with open(path, "wb") as f:
        pac.tofile(f)
        if l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l_pac % 4]))


def write_ann_amb(prefix: str, anns: List[ContigAnn], ambs: List[AmbHole],
                  l_pac: int, seed: int = 11):
    with open(prefix + ".ann", "w") as f:
        f.write(f"{l_pac} {len(anns)} {seed}\n")
        for a in anns:
            # bwa stores the literal "(null)" for missing comments
            # (bntseq.c:237, dumped by bns_dump)
            f.write(f"{a.gi} {a.name} {a.anno or '(null)'}\n")
            f.write(f"{a.offset} {a.length} {a.n_ambs}\n")
    with open(prefix + ".amb", "w") as f:
        f.write(f"{l_pac} {len(anns)} {len(ambs)}\n")
        for h in ambs:
            f.write(f"{h.offset} {h.length} {h.amb}\n")


def build_index(fasta: str, prefix: str = None, sa_intv: int = 32,
                write_files: bool = True) -> BwaIndex:
    """Full `bwa index` equivalent; returns the in-memory index and
    (optionally) writes prefix.{bwt,sa,ann,amb,pac}."""
    prefix = prefix or fasta
    anns, ambs, pac, l_pac = fasta2bnt(fasta)
    primary, L2, seq_len, bwt_arr, sa_intv, samp = build_fmindex(pac, l_pac,
                                                                 sa_intv)
    if write_files:
        write_pac_file(prefix + ".pac", pac, l_pac)
        write_ann_amb(prefix, anns, ambs, l_pac)
        write_bwt_file(prefix + ".bwt", primary, L2, bwt_arr)
        write_sa_file(prefix + ".sa", primary, L2, sa_intv, seq_len, samp)
    return BwaIndex(primary, L2, seq_len, bwt_arr, sa_intv, samp, l_pac,
                    anns, ambs, pac)
