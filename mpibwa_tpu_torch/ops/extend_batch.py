"""Batched banded seed-extension DP (ksw_extend2 semantics), PyTorch.

``extend_batch`` is the plain PyTorch version of the DP: the row-parallel
formulation of mpibwa_tpu/ops/extend_batch.py, one Python iteration per
target row with full-width tensor ops over the query, because E(i+1, j)
and F(i, j+1) derive from M(i, j) of the previous row (ksw.c:424-448) and
F is a max-plus prefix scan over the row's M. It is the reference the
CUDA kernel (ops/extend_cuda.py, csrc/extend.cu) is checked against, and
what the kernel's wrapper runs for tensors on the CPU.

``windows_from_coords`` builds the query and target windows on the device
from read rows and the packed reference (the global DP of
ops/global_batch.py takes its problems from it too);
``extend_from_coords`` calls the kernel wrapper on them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -(1 << 28)


def _maxscan_decay(t: torch.Tensor, decay: int, neg: int = NEG
                   ) -> torch.Tensor:
    """out[..., j] = max_{k<=j} (t[..., k] - (j-k)*decay) along the last
    axis, in log2(n) shift steps; positions before the row start read
    ``neg``."""
    n = t.shape[-1]
    out = t
    shift = 1
    while shift < n:
        fill = torch.full(out.shape[:-1] + (shift,), neg, dtype=out.dtype,
                          device=out.device)
        shifted = torch.cat([fill, out[..., :-shift]], dim=-1)
        out = torch.maximum(out, shifted - shift * decay)
        shift <<= 1
    return out


def band_limit(qlens: torch.Tensor, mmax, end_bonus: torch.Tensor, o: int,
               e: int) -> torch.Tensor:
    """ksw.c:399-407 ``max(1, (int)((qlen*mmax + end_bonus - o) / e + 1.))``
    in integer arithmetic: a truncating division equals the C cast of the
    float quotient once clamped to 1 (a negative numerator gives at most 1
    either way)."""
    num = qlens * mmax + end_bonus - o
    return torch.clamp(torch.div(num, e, rounding_mode="trunc") + 1, min=1)


class ExtendOut(NamedTuple):
    score: torch.Tensor
    qle: torch.Tensor
    tle: torch.Tensor
    gtle: torch.Tensor
    gscore: torch.Tensor
    max_off: torch.Tensor


def extend_batch(qs: torch.Tensor, ts: torch.Tensor, qlens: torch.Tensor,
                 tlens: torch.Tensor, params: torch.Tensor, mat: torch.Tensor,
                 o_del: int, e_del: int, o_ins: int, e_ins: int,
                 stats: "dict | None" = None) -> ExtendOut:
    """qs: (B, Q) uint8 query (nt4, pad 4); ts: (B, T) uint8 target;
    qlens/tlens: (B,) int32; params: (B, 4) int32 columns
    (w, end_bonus, zdrop, h0); mat: (5, 5) int32 scoring matrix. stats,
    when given, accumulates "cells": the DP cells inside the band of the
    rows these problems really visit (a tensor; the work a roofline bound
    of the kernel counts)."""
    B, Q = qs.shape
    T = ts.shape[1]
    dev = qs.device
    i32 = torch.int32
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qlens = qlens.to(i32)
    tlens = tlens.to(i32)
    w_in, end_bonus, zdrop, h0 = params.to(i32).unbind(1)
    mat = mat.reshape(5, 5).to(i32)
    qsl = qs.long()
    jidx = torch.arange(Q, dtype=i32, device=dev)
    jr = torch.arange(Q + 1, dtype=i32, device=dev)[None, :]

    # first-row fill (ksw.c:395-397): eh_h[0] = h0; eh_h[1] = max(h0 -
    # oe_ins, 0); eh_h[j] = eh_h[j-1] - e_ins while the previous > e_ins
    ehh1 = torch.clamp(h0 - oe_ins, min=0)
    jj = torch.arange(1, Q + 1, dtype=i32, device=dev)
    chain_val = ehh1[:, None] - (jj[None, :] - 1) * e_ins
    ok_prev = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                         chain_val[:, :-1] > e_ins], dim=1)
    ok_chain = torch.cumprod(ok_prev.to(i32), dim=1).bool()
    first_row = torch.where(ok_chain & (jj[None, :] <= qlens[:, None]),
                            torch.clamp(chain_val, min=0), 0)
    eh_h = torch.cat([h0[:, None], first_row], dim=1).to(i32)  # (B, Q+1)
    eh_e = torch.zeros((B, Q + 1), dtype=i32, device=dev)

    mmax = mat.max()
    w = torch.minimum(torch.minimum(
        w_in, band_limit(qlens, mmax, end_bonus, o_ins, e_ins)),
        band_limit(qlens, mmax, end_bonus, o_del, e_del)).to(i32)

    beg = torch.zeros(B, dtype=i32, device=dev)
    end = qlens.clone()
    maxv = h0.clone()
    max_i = torch.full((B,), -1, dtype=i32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros(B, dtype=i32, device=dev)
    broken = tlens <= 0
    rows = torch.arange(B, device=dev)

    i = 0
    while bool((~broken & (i < tlens)).any()):
        act = ~broken & (i < tlens)
        beg_r = torch.maximum(beg, i - w)
        end_r = torch.minimum(torch.minimum(end, i + w + 1), qlens)
        empty = beg_r >= end_r
        act2 = act & ~empty
        if stats is not None:
            stats["cells"] = stats.get("cells", 0) + torch.where(
                act2, end_r - beg_r, 0).sum(dtype=torch.int64)

        tb = ts[:, min(i, T - 1)].long()
        srow = mat[tb[:, None], qsl]  # (B, Q)
        live = (jidx[None, :] >= beg_r[:, None]) & (jidx[None, :]
                                                    < end_r[:, None])
        h1_first = torch.where(
            beg_r == 0, torch.clamp(h0 - (o_del + e_del * (i + 1)), min=0), 0)
        Hprev = eh_h[:, :Q]  # H(i-1, j-1) at cell j
        E = eh_e[:, :Q]
        M = torch.where(Hprev != 0, Hprev + srow, 0)
        Tm = torch.where(live, torch.clamp(M - oe_ins, min=0), NEG)
        scan = _maxscan_decay(Tm, e_ins)
        Fs = torch.cat([torch.full((B, 1), NEG, dtype=i32, device=dev),
                        scan[:, :-1]], dim=1)
        F = torch.where(jidx[None, :] == beg_r[:, None], 0, Fs)
        H = torch.where(live, torch.maximum(torch.maximum(M, E), F), 0)
        m = torch.where(live, H, -1).max(dim=1).values
        m = torch.where(end_r > beg_r, torch.clamp(m, min=0), 0)
        is_max = live & (H == m[:, None]) & (m[:, None] > 0)
        mj = torch.where(is_max, jidx[None, :], -1).max(dim=1).values
        newE = torch.maximum(torch.clamp(M - oe_del, min=0), E - e_del)

        # row writes for active lanes: eh_h[beg] = h1_first, eh_h[j] =
        # H[j-1] for j in [beg+1, end]; eh_e[j] = newE[j] for j in
        # [beg, end), eh_e[end] = 0
        upd = act2[:, None]
        H_sh = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev), H],
                         dim=1)
        write_h = (jr > beg_r[:, None]) & (jr <= end_r[:, None])
        new_eh_h = torch.where(write_h & upd, H_sh, eh_h)
        new_eh_h = torch.where((jr == beg_r[:, None]) & upd,
                               h1_first[:, None], new_eh_h)
        write_e = (jr >= beg_r[:, None]) & (jr < end_r[:, None])
        newE_pad = torch.cat([newE, torch.zeros((B, 1), dtype=i32,
                                                device=dev)], dim=1)
        new_eh_e = torch.where(write_e & upd, newE_pad, eh_e)
        new_eh_e = torch.where((jr == end_r[:, None]) & upd, 0, new_eh_e)

        h1_last = torch.where(end_r > beg_r,
                              H[rows, torch.clamp(end_r - 1, min=0).long()],
                              h1_first)
        # gscore at the full query (ksw.c:450-453)
        at_q = act2 & (end_r == qlens)
        upd_ie = at_q & ~(gscore > h1_last)
        new_max_ie = torch.where(upd_ie, i, max_ie)
        new_gscore = torch.where(at_q, torch.maximum(gscore, h1_last), gscore)

        zero_m = act2 & (m == 0)
        better = act2 & ~zero_m & (m > maxv)
        new_maxv = torch.where(better, m, maxv)
        new_max_i = torch.where(better, i, max_i)
        new_max_j = torch.where(better, mj, max_j)
        new_max_off = torch.where(
            better, torch.maximum(max_off, torch.abs(mj - i)), max_off)
        # z-drop (ksw.c:458-463) for rows that did not improve
        di = i - max_i
        dj = mj - max_j
        zd1 = maxv - m - (di - dj) * e_del > zdrop
        zd2 = maxv - m - (dj - di) * e_ins > zdrop
        zbreak = (act2 & ~zero_m & ~better & (zdrop > 0)
                  & torch.where(di > dj, zd1, zd2))

        # band trimming over the updated eh arrays (ksw.c:466-469)
        nz = (new_eh_h != 0) | (new_eh_e != 0)  # (B, Q+1)
        in_range = (jr >= beg_r[:, None]) & (jr < end_r[:, None])
        first_nz = torch.where(in_range & nz, jr, Q + 1).min(dim=1).values
        new_beg = torch.minimum(first_nz, end_r)
        in_range2 = (jr >= new_beg[:, None]) & (jr <= end_r[:, None])
        last_nz = torch.where(in_range2 & nz, jr,
                              new_beg[:, None] - 1).max(dim=1).values
        new_end = torch.minimum(last_nz + 2, qlens)

        broken = broken | zero_m | zbreak | (act & empty)
        eh_h, eh_e = new_eh_h, new_eh_e
        beg = torch.where(act2, new_beg, beg)
        end = torch.where(act2, new_end, end)
        maxv = torch.where(act2, new_maxv, maxv)
        max_i = torch.where(act2, new_max_i, max_i)
        max_j = torch.where(act2, new_max_j, max_j)
        max_ie = torch.where(act2, new_max_ie, max_ie)
        gscore = torch.where(act2, new_gscore, gscore)
        max_off = torch.where(act2, new_max_off, max_off)
        i += 1
    return ExtendOut(maxv, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off)


def windows_from_coords(fm, qd: torch.Tensor, coords: torch.Tensor, Q: int,
                        T: int):
    """(qs (B, Q), ts (B, T) uint8 padded with 4, q_len, t_len int32) of
    the problems at coords, gathered on the device from the read batch qd
    (NR, L) uint8 and fm's packed reference.

    coords: (B, 6) int64 columns (row, q_off, q_len, q_rev, r_start,
    t_len): the query is qd[row, q_off : q_off+q_len] (reversed if q_rev)
    and the target is t_len reference bases from doubled-coordinate
    r_start, walking down from r_start-1 when q_rev (left extension
    mirrors both sequences, bwamem.c:716-722). r_start must stay int64."""
    dev = qd.device
    NR, L = qd.shape
    row = coords[:, 0].long().clamp(0, NR - 1)
    q_off = coords[:, 1].to(torch.int32)
    q_len = coords[:, 2].to(torch.int32)
    q_rev = coords[:, 3] != 0
    r_start = coords[:, 4].to(torch.int64)
    t_len = coords[:, 5].to(torch.int32)
    jq = torch.arange(Q, dtype=torch.int32, device=dev)[None, :]
    qpos = torch.where(q_rev[:, None],
                       q_off[:, None] + q_len[:, None] - 1 - jq,
                       q_off[:, None] + jq)
    qvalid = jq < q_len[:, None]
    qs = torch.where(qvalid, qd[row[:, None], qpos.clamp(0, L - 1).long()],
                     4).to(torch.uint8)
    jt = torch.arange(T, dtype=torch.int64, device=dev)[None, :]
    tpos = torch.where(q_rev[:, None], r_start[:, None] - 1 - jt,
                       r_start[:, None] + jt)
    tvalid = jt < t_len[:, None]
    ts = torch.where(tvalid,
                     fm.ref_base(tpos.clamp(0, 2 * fm.l_pac - 1)),
                     4).to(torch.uint8)
    return qs, ts, q_len.contiguous(), t_len.contiguous()


def extend_from_coords(fm, qd: torch.Tensor, coords: torch.Tensor, Q: int,
                       T: int, params: torch.Tensor, o_del: int, e_del: int,
                       o_ins: int, e_ins: int, mat: torch.Tensor
                       ) -> ExtendOut:
    """Build extension problems on the device from coordinates (as
    windows_from_coords) and run the DP through the kernel wrapper.
    params: (B, 4) int32 (w, end_bonus, zdrop, h0). Only coordinates
    cross the host link; sequences are gathered from the device-resident
    read batch and packed reference."""
    # imported here: extend_cuda imports this module for the plain version
    from mpibwa_tpu_torch.ops.extend_cuda import extend_batch_kernel

    qs, ts, q_len, t_len = windows_from_coords(fm, qd, coords, Q, T)
    return extend_batch_kernel(qs, ts, q_len, t_len,
                               params.to(torch.int32).contiguous(), mat,
                               o_del, e_del, o_ins, e_ins)
