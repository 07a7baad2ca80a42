"""Batched mate-rescue local SW (ksw_align2 / ksw_u8 semantics), PyTorch.

Counterpart of mpibwa_tpu/ops/rescue.py, used by the record route
(pipeline/device_align.precompute_rescue). It reproduces the striped SSE2
kernel's exact outputs (ksw.c:111-230, 343-365): the padded-query SW
matrix (the query padded to slen*16 positions with zero scores), the u8
bias and saturation arithmetic (in int32: a uint8 tensor would wrap), the
per-column second-best tracking with its contiguous-run merge rule, the
least query position among the maxima for qe, and the reverse pass that
recovers the start positions. One Python iteration per target row, as in
ops/extend_batch.py. Sequences never cross the host link: the mate is
gathered from the device read batch (complemented and reversed when
asked) and the reference window from the packed reference.

i16 problems (long mates, l_ms * a >= 250) are not batched: they miss
the cache and core/pair runs the scalar kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpibwa_tpu_torch.ops.extend_batch import _maxscan_decay


class SWOut(NamedTuple):
    score: torch.Tensor  # (B,) capped at 255 like u8
    te: torch.Tensor  # (B,)
    qe: torch.Tensor  # (B,)
    score2: torch.Tensor  # (B,); its row te2 is not kept: nothing reads it


def _score2(cm: torch.Tensor, tlen: torch.Tensor, minsc: torch.Tensor,
            score: torch.Tensor, te: torch.Tensor, qmax: int) -> torch.Tensor:
    """The second best of ksw_u8 (ksw.c:192-199, 214-227) from the column
    maxima cm (B, T).

    The C kernel appends an entry (value, row) for each row with colmax >=
    minsc; a row extends the last entry instead when it follows that
    entry's row directly, and then raises its value only on a strict
    improvement, keeping its row. So a row that neither starts a run nor
    improves on the row before is "absorbed" (no new entry, no update),
    and the row after an absorbed one starts a new entry. absorbed[i] =
    d[i] & ~absorbed[i-1], with d the rows inside a run that do not
    improve: within a stretch of d that follows position z (the last row
    with d false), the rows at an odd distance from z are absorbed. An
    entry's value is the largest of its rows, its row the last of them;
    score2 is the largest entry whose row lies outside te +- the window."""
    B, T = cm.shape
    dev = cm.device
    tidx = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    f_col = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    inb = (cm >= minsc[:, None]) & (tidx < tlen[:, None])
    run_start = inb & ~torch.cat([f_col, inb[:, :-1]], dim=1)
    prev_cm = torch.cat([torch.zeros((B, 1), dtype=cm.dtype, device=dev),
                         cm[:, :-1]], dim=1)
    d = inb & ~run_start & (cm <= prev_cm)
    z = torch.cummax(torch.where(d, -1, tidx), dim=1).values
    absorbed = d & (((tidx - z) & 1) == 1)
    start_e = inb & (run_start | torch.cat([f_col, absorbed[:, :-1]], dim=1))
    entry_rows = inb & ~absorbed
    # entry ids: 0 before the first entry; the rows after an entry's last
    # row and before the next entry are outside every run (value -1)
    seg = torch.cumsum(start_e.to(torch.int64), dim=1)
    flat = (torch.arange(B, device=dev)[:, None] * (T + 1) + seg).reshape(-1)

    def seg_max(v):
        out = torch.full((B * (T + 1),), -1, dtype=torch.int32, device=dev)
        out.scatter_reduce_(0, flat, torch.where(entry_rows, v, -1)
                            .to(torch.int32).reshape(-1), "amax")
        return out[flat].reshape(B, T)

    segval = seg_max(cm)
    segidx = seg_max(tidx.expand(B, T))
    seg_end = inb & (torch.cat([start_e[:, 1:], f_col], dim=1)
                     | ~torch.cat([inb[:, 1:], f_col], dim=1))
    win = torch.div(score + qmax - 1, qmax, rounding_mode="floor")
    low = (te - win)[:, None]
    high = (te + win)[:, None]
    qual = seg_end & ((segidx < low) | (segidx > high))
    score2 = torch.where(qual, segval, -1).max(dim=1).values
    # C fills score2 only when score != 255 (and the entries are nonempty)
    return torch.where(score != 255, score2, -1)


def striped_sw_u8(fm, qd: torch.Tensor, qcoords: torch.Tensor, N: int,
                  T: int, tcoords: torch.Tensor, o_del: int, e_del: int,
                  o_ins: int, e_ins: int, shift: int, qmax: int,
                  params: torch.Tensor, mat: torch.Tensor) -> SWOut:
    """qcoords: (B, 5) int32 (row, start, step, comp, qlen): query position
    k reads qd[row, start + k*step], complemented (3-x, N stays) if comp.
    tcoords: (B, 3) int64 (t_start, t_step, t_len) over doubled reference
    coordinates. params: (B, 2) int32 (minsc, endsc). N: padded query
    capacity (a multiple of 16 covering slen*16); T: padded target
    capacity. shift = 256 - min(mat) (mod 256); qmax = max(mat); mat: (5,
    5) int32 on qd's device."""
    B = qcoords.shape[0]
    dev = qd.device
    i32 = torch.int32
    L = qd.shape[1]
    qcoords = qcoords.to(i32)
    row = qcoords[:, 0].long().clamp(0, qd.shape[0] - 1)
    qstart, qstep = qcoords[:, 1], qcoords[:, 2]
    qcomp = qcoords[:, 3] != 0
    qlen = qcoords[:, 4]
    minsc, endsc = params.to(i32).unbind(1)
    mat = mat.reshape(5, 5).to(i32)

    # padded query per the striped layout: nlen = ceil(qlen/16)*16
    nlen = ((qlen + 15) >> 4) << 4
    k = torch.arange(N, dtype=i32, device=dev)[None, :]
    qpos = qstart[:, None] + k * qstep[:, None]
    qraw = qd[row[:, None], qpos.clamp(0, L - 1).long()].to(i32)
    qraw = torch.where(qcomp[:, None] & (qraw < 4), 3 - qraw, qraw)
    qvalid = k < qlen[:, None]
    qb = torch.where(qvalid, qraw, 0).long()
    lanemask = k < nlen[:, None]
    smask = qvalid & lanemask  # padding positions score 0

    tstart = tcoords[:, 0].to(torch.int64)
    tstep = tcoords[:, 1].to(torch.int64)
    tlen = tcoords[:, 2].to(i32)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)
    H = torch.zeros((B, N), dtype=i32, device=dev)
    E = torch.zeros_like(H)
    Hmax = torch.zeros_like(H)
    gmax = torch.zeros(B, dtype=i32, device=dev)
    te = torch.full((B,), -1, dtype=i32, device=dev)
    colmax = torch.zeros((B, T), dtype=i32, device=dev)
    broken = tlen <= 0
    n_rows = min(int(tlen.max()), T) if B else 0
    for i in range(n_rows):
        # every 16 rows, stop once every problem has broken or ended
        if i % 16 == 15 and not bool((~broken & (i < tlen)).any()):
            break
        act = ~broken & (i < tlen)
        tb = fm.ref_base((tstart + i * tstep).clamp(0, 2 * fm.l_pac - 1))
        S = torch.where(smask, mat[tb.long()[:, None], qb], 0)
        Hd = torch.cat([zero_col, H[:, :-1]], dim=1)
        # u8: max(min(Hdiag + S + shift, 255) - shift, 0)
        hm = torch.clamp(torch.clamp(Hd + S + shift, max=255) - shift, min=0)
        Hnf = torch.maximum(hm, E)
        scan = _maxscan_decay(torch.clamp(Hnf - oe_ins, min=0), e_ins)
        F = torch.cat([zero_col, scan[:, :-1]], dim=1)
        Hrow = torch.where(lanemask, torch.maximum(Hnf, F), 0)
        newE = torch.where(lanemask, torch.maximum(
            torch.clamp(E - e_del, min=0), torch.clamp(Hrow - oe_del, min=0)),
            0)
        imax = Hrow.max(dim=1).values
        better = act & (imax > gmax)
        H = torch.where(act[:, None], Hrow, H)
        E = torch.where(act[:, None], newE, E)
        Hmax = torch.where(better[:, None], Hrow, Hmax)
        gmax = torch.where(better, imax, gmax)
        te = torch.where(better, i, te)
        colmax[:, i] = torch.where(act, imax, colmax[:, i])
        broken = broken | (better & ((gmax + shift >= 255)
                                     | (gmax >= endsc)))

    score = torch.where(gmax + shift < 255, gmax, 255)
    # qe: the least query position among the maxima of Hmax (padding
    # included)
    mx = Hmax.max(dim=1).values
    qe = torch.where(Hmax == mx[:, None], k, N).min(dim=1).values
    qe = torch.where(score != 255, qe, -1)
    score2 = _score2(colmax, tlen, minsc, score, te, qmax)
    return SWOut(score, te, qe, score2)


def _pull(o: SWOut, B: int) -> np.ndarray:
    """score, te, qe, score2 of the first B problems in one device read."""
    return torch.stack([o.score, o.te, o.qe, o.score2])[:, :B].cpu().numpy()


def ksw_align2_batch(fm, qd, problems, opt, N: int, T: int):
    """Full ksw_align2 (forward and reverse pass) for a list of u8 problems.

    problems: list of dicts with qcoords (row, start, step, comp, qlen) and
    tcoords (t_start, t_step, t_len); all share xtra =
    XSUBO|XSTART|XBYTE|minsc (mem_matesw, bwamem_pair.c:150).
    Returns a list of KswR-shaped (score, te, qe, score2, te2, tb, qb),
    te2 always -1."""
    B = len(problems)
    if B == 0:
        return []
    dev = qd.device
    m5 = opt.mat.reshape(5, 5)
    shift = (256 - int(m5.min())) & 0xFF
    qmax = int(m5.max())
    minsc = opt.min_seed_len * opt.a
    mat = torch.from_numpy(m5.astype(np.int32)).to(dev)

    def run(qc, tc, pr):
        return striped_sw_u8(fm, qd, torch.from_numpy(qc).to(dev), N, T,
                             torch.from_numpy(tc).to(dev), opt.o_del,
                             opt.e_del, opt.o_ins, opt.e_ins, shift, qmax,
                             torch.from_numpy(pr).to(dev), mat)

    def arrays(n):
        Bp = 1 << max(4, (n - 1).bit_length())
        qc = np.zeros((Bp, 5), np.int32)
        qc[:, 4] = 1
        return qc, np.zeros((Bp, 3), np.int64), np.zeros((Bp, 2), np.int32)

    qc, tc, pr = arrays(B)
    for i, p in enumerate(problems):
        qc[i] = p["qcoords"]
        tc[i] = p["tcoords"]
    pr[:B] = (minsc, 0x10000)
    score, te, qe, score2 = _pull(run(qc, tc, pr), B)
    # the reverse pass for problems with score >= minsc (the caller discards
    # the rest, and ksw_align2 skips XSTART when XSUBO && score < minsc)
    rev_idx = [i for i in range(B)
               if score[i] >= minsc and score[i] != 255 and qe[i] >= 0]
    rev_res = {}
    if rev_idx:
        qc2, tc2, pr2 = arrays(len(rev_idx))
        for j, i in enumerate(rev_idx):
            r0, st, sp, cp, _ = qc[i]
            qc2[j] = (r0, st + qe[i] * sp, -sp, cp, qe[i] + 1)
            ts0, tsp, _ = tc[i]
            tc2[j] = (ts0 + te[i] * tsp, -tsp, te[i] + 1)
            pr2[j] = (0x10000, score[i])  # KSW_XSTOP | r.score
        rsc, rte, rqe, _ = _pull(run(qc2, tc2, pr2), len(rev_idx))
        rev_res = {i: (rsc[j], rte[j], rqe[j]) for j, i in enumerate(rev_idx)}
    out = []
    for i in range(B):
        tb = qb = -1
        if i in rev_res and rev_res[i][0] == score[i]:
            tb = int(te[i] - rev_res[i][1])
            qb = int(qe[i] - rev_res[i][2])
        out.append((int(score[i]), int(te[i]), int(qe[i]), int(score2[i]),
                    -1, tb, qb))
    return out
