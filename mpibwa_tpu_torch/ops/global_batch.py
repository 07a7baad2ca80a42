"""Batched banded global alignment (ksw_global2 semantics), PyTorch.

Counterpart of mpibwa_tpu/ops/global_batch.py, used by the record route
(pipeline/device_align.precompute_cigars) for the CIGARs of every
region. ``global_batch`` computes each problem's score and its full
direction matrix z with the row-parallel formulation of the extension DP
(ops/extend_batch.py): one Python iteration per target row, full-width
tensor ops over the query. The direction encoding is ksw.c:546-565: bits
0-1 the H source, bit 2 E-extend, bit 5 F-extend.

``traceback_batch`` walks every problem back in lockstep on the device,
so that only (B, T+Q) op rows cross to the host (z is T*Q bytes a
problem); ``cigar_from_ops`` run-length-encodes a row on the host.
``traceback`` is the host walk over one z matrix (ksw.c:588-602), the
plain reference of the two. ``global_from_coords`` builds the problems on
the device from coordinates.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from mpibwa_tpu_torch.ops.extend_batch import (_maxscan_decay,
                                               windows_from_coords)

MINUS_INF = -0x40000000


class GlobalOut(NamedTuple):
    score: torch.Tensor  # (B,) int32
    z: torch.Tensor  # (B, T, Q) uint8 direction matrix


def global_batch(qs: torch.Tensor, ts: torch.Tensor, qlens: torch.Tensor,
                 tlens: torch.Tensor, ws: torch.Tensor, mat: torch.Tensor,
                 o_del: int, e_del: int, o_ins: int, e_ins: int
                 ) -> GlobalOut:
    """qs: (B, Q) uint8 query (nt4, pad 4); ts: (B, T) uint8 target;
    qlens/tlens/ws: (B,) int32 lengths and bands; mat: (5, 5) int32
    scoring matrix."""
    B, Q = qs.shape
    T = ts.shape[1]
    dev = qs.device
    i32 = torch.int32
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qlens = qlens.to(i32)
    tlens = tlens.to(i32)
    ws = ws.to(i32)
    mat = mat.reshape(5, 5).to(i32)
    qsl = qs.long()
    jidx = torch.arange(Q, dtype=i32, device=dev)[None, :]
    jr = torch.arange(Q + 1, dtype=i32, device=dev)[None, :]
    col0 = torch.zeros((B, 1), dtype=i32, device=dev)
    neg0 = torch.full((B, 1), MINUS_INF, dtype=i32, device=dev)

    # first row (ksw.c:522-525)
    jj = torch.arange(1, Q + 1, dtype=i32, device=dev)[None, :]
    in_band = jj <= torch.minimum(qlens, ws)[:, None]
    eh_h = torch.cat([col0, torch.where(in_band, -(o_ins + e_ins * jj),
                                        MINUS_INF)], dim=1)
    eh_e = torch.full((B, Q + 1), MINUS_INF, dtype=i32, device=dev)
    z = torch.zeros((B, T, Q), dtype=torch.uint8, device=dev)

    n_rows = int(tlens.max()) if B else 0
    for i in range(n_rows):
        upd = (i < tlens)[:, None]
        beg = torch.clamp(i - ws, min=0)[:, None]
        end = torch.minimum(i + ws + 1, qlens)[:, None]
        tb = ts[:, i].long()
        srow = mat[tb[:, None], qsl]  # (B, Q)
        live = (jidx >= beg) & (jidx < end)
        h1_first = torch.where(beg == 0, -(o_del + e_del * (i + 1)),
                               MINUS_INF)
        M = eh_h[:, :Q] + srow
        E = eh_e[:, :Q]
        scan = _maxscan_decay(torch.where(live, M, MINUS_INF) - oe_ins,
                              e_ins, MINUS_INF)
        F = torch.cat([neg0, scan[:, :-1]], dim=1)
        F = torch.where(jidx == beg, MINUS_INF, F)
        d = (M < E).to(i32)
        H = torch.maximum(M, E)
        d = torch.where(H >= F, d, 2)
        H = torch.maximum(H, F)
        d = (d | ((E - e_del) > (M - oe_del)).to(i32) << 2
             | ((F - e_ins) > (M - oe_ins)).to(i32) << 5)
        z[:, i] = torch.where(live & upd, d, 0).to(torch.uint8)
        newE = torch.maximum(M - oe_del, E - e_del)

        H_sh = torch.cat([col0, H], dim=1)
        new_h = torch.where((jr > beg) & (jr <= end) & upd, H_sh, eh_h)
        eh_h = torch.where((jr == beg) & upd, h1_first, new_h)
        new_e = torch.cat([newE, col0], dim=1)
        eh_e = torch.where((jr >= beg) & (jr < end) & upd, new_e, eh_e)
        eh_e = torch.where((jr == end) & upd, MINUS_INF, eh_e)
    score = eh_h[torch.arange(B, device=dev), qlens.long()]
    return GlobalOut(score, z)


def traceback(z: np.ndarray, qlen: int, tlen: int, w: int
              ) -> List[Tuple[int, int]]:
    """ksw_global2 traceback (ksw.c:588-602) over one full-width z matrix.
    Returns cigar [(len, op)] with op 0=M, 1=I, 2=D."""
    cigar: List[List[int]] = []

    def push(op, ln):
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += ln
        else:
            cigar.append([op, ln])

    i = tlen - 1
    k = (i + w + 1 if i + w + 1 < qlen else qlen) - 1
    which = 0
    while i >= 0 and k >= 0:
        which = (int(z[i, k]) >> (which << 1)) & 3
        if which == 0:
            push(0, 1)
            i -= 1
            k -= 1
        elif which == 1:
            push(2, 1)
            i -= 1
        else:
            push(1, 1)
            k -= 1
    if i >= 0:
        push(2, i + 1)
    if k >= 0:
        push(1, k + 1)
    cigar.reverse()
    return [(ln, op) for op, ln in cigar]


def traceback_batch(z: torch.Tensor, qlens: torch.Tensor, tlens: torch.Tensor,
                    ws: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device traceback of the whole batch in lockstep (ksw.c:588-602).

    Returns (ops (B, T+Q) uint8 in walk order with 255 padding, i_rem,
    k_rem): the host run-length-encodes ops and appends the leftover D/I
    tails (cigar_from_ops), so the (B, T, Q) matrix never leaves the
    device. A walk takes at most tlen + qlen steps."""
    B, T, Q = z.shape
    dev = z.device
    rows = torch.arange(B, device=dev)
    tlens = tlens.to(torch.int32)
    qlens = qlens.to(torch.int32)
    i = tlens - 1
    k = torch.minimum(i + ws.to(torch.int32) + 1, qlens) - 1
    which = torch.zeros(B, dtype=torch.int32, device=dev)
    ops = torch.full((B, T + Q), 255, dtype=torch.uint8, device=dev)
    n_steps = min(T + Q, int((tlens + qlens).max())) if B else 0
    for s in range(n_steps):
        alive = (i >= 0) & (k >= 0)
        zval = z[rows, i.clamp(0, T - 1).long(),
                 k.clamp(0, Q - 1).long()].to(torch.int32)
        w2 = (zval >> (which << 1)) & 3
        # op codes as traceback's push(): 0=M, 2=D (i-1), 1=I (k-1)
        op = torch.where(w2 == 0, 0, torch.where(w2 == 1, 2, 1))
        ops[:, s] = torch.where(alive, op, 255).to(torch.uint8)
        i = torch.where(alive & (w2 != 2), i - 1, i)
        k = torch.where(alive & (w2 != 1), k - 1, k)
        which = torch.where(alive, w2, which)
    return ops, i, k


def cigar_from_ops(ops_row: np.ndarray, i_rem: int, k_rem: int
                   ) -> List[Tuple[int, int]]:
    """Host run-length encoding of a device traceback row; replicates the
    push/merge, tail pushes and reversal of ``traceback``."""
    pad = ops_row == 255
    n = int(np.argmax(pad)) if pad.any() else len(ops_row)
    cigar: List[List[int]] = []
    if n:
        row = ops_row[:n].astype(np.int64)
        brk = np.nonzero(np.diff(row))[0]
        starts = np.concatenate([[0], brk + 1])
        ends = np.concatenate([brk + 1, [n]])
        cigar = [[int(row[s]), int(e - s)] for s, e in zip(starts, ends)]

    def push(op, ln):
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += ln
        else:
            cigar.append([op, ln])

    if i_rem >= 0:
        push(2, i_rem + 1)
    if k_rem >= 0:
        push(1, k_rem + 1)
    cigar.reverse()
    return [(ln, op) for op, ln in cigar]


def global_from_coords(fm, qd: torch.Tensor, coords: torch.Tensor, Q: int,
                       T: int, ws: torch.Tensor, o_del: int, e_del: int,
                       o_ins: int, e_ins: int, mat: torch.Tensor
                       ) -> GlobalOut:
    """The global DP of problems built on the device from coordinates, as
    ops.extend_batch.windows_from_coords reads them: (row, q_off, q_len,
    q_rev, r_start, t_len) int64, the reverse-strand case walking down from
    r_start (= re), which reproduces gen_cigar's double reversal
    (bwa.c:135-140)."""
    qs, ts, q_len, t_len = windows_from_coords(fm, qd, coords, Q, T)
    return global_batch(qs, ts, q_len, t_len, ws, mat, o_del, e_del, o_ins,
                        e_ins)
