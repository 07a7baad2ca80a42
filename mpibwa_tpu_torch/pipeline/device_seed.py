"""Device-batched seed collection: exact mem_collect_intv on torch tensors.

Counterpart of mpibwa_tpu/pipeline/device_seed.py. Drives the forward
automata (ops/fwd_cuda.py: one kernel launch a pass on a CUDA device, the
host loops of ops/seeding.py on the CPU) and a backward engine over a
read batch and
assembles, per read, the same interval list that core.chain.collect_intv
produces (collect_batch), or the same intervals as flat arrays
(collect_flat). Reads that overflow a device buffer fall back to the
scalar host engine.

Backward engines (MPIBWA_BWD): auto runs each pass as one launch of the
CUDA pass kernel (ops/bwd_cuda.py) on a CUDA device with the int32
position path, v8 on a CUDA device with the int64 path, and the exact
"flat" engine (ops/seeding_flat.py) on the CPU; each choice was timed on
an H100 against the others (PERF.md). flat forces the flat engine; pallas
takes the pass kernel on any int32 index (its plain pass on the CPU) and
pallas_interp the plain pass on any device; v8 is the JAX package's
accelerator engine, either position dtype: on a CUDA device each pass is
one launch of the v8 kernel (ops/v8_cuda.py, csrc/bwd_v8.cu), on the CPU
its plain version ops/backward8.py, whose overflow is redone on the flat
engine; contig is the JAX package's opt-in contig
engine (ops/seeding_flat.py, either position dtype), which auto never
picks. In collect_flat, v8 and the pass engine hand back the rows of the
mems, filtered and compacted on the device; flat and contig go through
per-lane lists. Under v8, pass 2 builds its lane tables
on the device from the second batch on (the speculative route), so the
host does not wait between pass 2's forward and its backward; a capacity
miss redoes it on the synchronous route.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from mpibwa_tpu_torch.core.sortutil import ks_introsort
from mpibwa_tpu_torch.io.columns import ReadColumns
from mpibwa_tpu_torch.ops import backward8 as B8
from mpibwa_tpu_torch.ops import fwd_cuda
from mpibwa_tpu_torch.ops import seeding
from mpibwa_tpu_torch.ops import seeding_flat as SF
from mpibwa_tpu_torch.ops import v8_cuda
from mpibwa_tpu_torch.ops.pulls import pull_prefix, pull_prefix_async


def _pad_batch(qs) -> Tuple[np.ndarray, np.ndarray]:
    """The (B, L) code matrix, padded with 4, and the lengths of qs: one
    array a read, or a batch's ReadColumns (its seq column copied in one
    step)."""
    B = len(qs)
    cols = qs if isinstance(qs, ReadColumns) else None
    if cols is not None:
        lens = np.diff(cols.seq_off).astype(np.int32)
        L = int(lens.max()) if B else 1
    else:
        L = max((len(q) for q in qs), default=1)
    L = max(L, 8)
    if L >= (1 << 21):  # 21-bit call fields in the fused p1/p3 pull
        raise ValueError("reads >= 2 Mbp unsupported by the device seeder")
    out = np.full((B, L), 4, dtype=np.uint8)
    if cols is not None:
        if B and (lens == lens[0]).all():
            out[:, : lens[0]] = cols.seq.reshape(B, int(lens[0]))
        else:  # each base to its row's start plus its place in the read
            starts = np.arange(B, dtype=np.int64) * L - cols.seq_off[:-1]
            out.reshape(-1)[np.repeat(starts, lens)
                            + np.arange(len(cols.seq))] = cols.seq
        return out, lens
    lens = np.zeros(B, dtype=np.int32)
    for i, q in enumerate(qs):
        out[i, : len(q)] = q
        lens[i] = len(q)
    return out, lens


def _backward_engine(fm) -> str:
    """The backward engine for index fm (its ``device`` and ``idt``)."""
    mode = os.environ.get("MPIBWA_BWD", "auto")
    if mode == "auto":
        if fm.device.type != "cuda":
            return "flat"
        return "pallas" if fm.idt == torch.int32 else "v8"
    if mode in ("flat", "pallas", "pallas_interp", "v8", "contig"):
        return mode
    raise ValueError(f"unknown MPIBWA_BWD={mode!r}")


def _v8_lanes(n: int) -> int:
    """Lane count of a v8 pass of n lanes: a power of two, at least 16."""
    return max(16, 1 << (n - 1).bit_length())


def _lane_tables(arr: np.ndarray, NLp: int):
    """Lane tables of the call rows arr ((N, 5) [row, push_start,
    push_len, x, min_intv]) padded with zero-length lanes to NLp: (lane_row,
    lane_tbl (NLp, 3) [push_start, push_len, entry_start], x0, minv, the
    entry count)."""
    N = arr.shape[0]
    lane_row = np.zeros(NLp, np.int32)
    lane_tbl = np.zeros((NLp, 3), np.int32)
    x0 = np.zeros(NLp, np.int32)
    minv = np.ones(NLp, np.int64)
    lane_row[:N] = arr[:, 0]
    lane_tbl[:N, 0] = arr[:, 1]
    lane_tbl[:N, 1] = arr[:, 2]
    starts = np.zeros(N, np.int64)
    if N > 1:
        np.cumsum(arr[:-1, 2], out=starts[1:])
    lane_tbl[:N, 2] = starts
    x0[:N] = arr[:, 3]
    minv[:N] = arr[:, 4]
    e = int(arr[:, 2].sum())
    lane_tbl[N:, 2] = e  # pad lanes: zero-length at the end
    return lane_row, lane_tbl, x0, minv, e


def _p2_tables(fwd2, cap: int):
    """Pass 2's backward lane tables on the device, from its single-call
    forward: lane_tbl rows [push_start, len, entry_start], x0 of each lane,
    a control vector [entries] ++ the lanes' overflow flags (pulled after
    the backward) and a device flag for "the entries exceed cap". Lanes
    whose forward overflowed count as zero-length: their reads go to the
    host engine, and their call length is no bound."""
    live = (fwd2.n_calls > 0) & ~fwd2.overflow
    ln = torch.where(live, fwd2.call_len[:, 0], 0).to(torch.int32)
    starts = (torch.cumsum(ln, 0) - ln).to(torch.int32)
    ltbl = torch.stack([fwd2.call_start[:, 0].to(torch.int32), ln, starts],
                       dim=1)
    e2 = ln.sum()
    ctl = torch.cat([e2.to(torch.int32)[None],
                     fwd2.overflow.to(torch.int32)])
    return ltbl, fwd2.call_x[:, 0].to(torch.int32), ctl, e2 > cap


def _pack_fwd(fwd) -> torch.Tensor:
    """A forward pass's five host-bound outputs in one int32 tensor
    (B, 2 + 3*C): [overflow, n_calls, call_x, call_start, call_len]."""
    i32 = torch.int32
    return torch.cat([fwd.overflow.to(i32)[:, None],
                      fwd.n_calls.to(i32)[:, None], fwd.call_x.to(i32),
                      fwd.call_start.to(i32), fwd.call_len.to(i32)], dim=1)


def _pack_fwd1(fwd) -> torch.Tensor:
    """Single-call variant: (B, 5) int32 = [overflow, n_calls, call_x[0],
    call_start[0], call_len[0]]."""
    i32 = torch.int32
    return torch.stack([fwd.overflow.to(i32), fwd.n_calls.to(i32),
                        fwd.call_x[:, 0].to(i32), fwd.call_start[:, 0].to(i32),
                        fwd.call_len[:, 0].to(i32)], dim=1)


def _fused_p1_p3(fm, qd, lensd, min_seed_len, max_intv):
    """Pass-1 forward + pass-3 automata in one loop, with the host-bound
    outputs compacted on the device so the pull tracks the content.

    Returns (ivals, infos, ctl, bufs): ctl = counts (B x [fwd_overflow,
    n_calls, p3_overflow, n_seeds]) ++ the compacted call words in read
    order (int32 x<<16|start<<8|len for L < 64 Ki, else int64
    x<<42|start<<21|len); bufs = the compacted pass-3 seed quads [s0, s1,
    s2, info] int64, flattened."""
    B, L = qd.shape
    dev = qd.device
    i32, i64 = torch.int32, torch.int64
    fwd, p3 = fwd_cuda.forward_p3_kernel(
        fm, qd, lensd, torch.ones(B, dtype=i64, device=dev), min_seed_len,
        max_intv)
    counts = torch.stack([fwd.overflow.to(i32), fwd.n_calls.to(i32),
                          p3.overflow.to(i32), p3.n_seeds.to(i32)], dim=1)
    C = fwd.call_x.shape[1]
    S = p3.infos.shape[1]
    cw = pack_call_words(fwd.call_x, fwd.call_start, fwd.call_len,
                         L).reshape(-1)
    cdt = cw.dtype
    maskc = (torch.arange(C, device=dev)[None, :]
             < fwd.n_calls.clamp(max=C)[:, None]).reshape(-1)
    posc = torch.cumsum(maskc.to(i64), 0) - 1
    bufc = torch.zeros(B * C + 1, dtype=cdt, device=dev)
    bufc[torch.where(maskc, posc, B * C)] = cw.to(cdt)
    ctl = torch.cat([counts.reshape(-1).to(cdt), bufc[: B * C]])

    quads = torch.cat([p3.seeds.to(i64), p3.infos.to(i64)[:, :, None]],
                      dim=2).reshape(B * S, 4)
    masks = (torch.arange(S, device=dev)[None, :]
             < p3.n_seeds.clamp(max=S)[:, None]).reshape(-1)
    poss = torch.cumsum(masks.to(i64), 0) - 1
    bufs = torch.zeros((B * S + 1, 4), dtype=i64, device=dev)
    bufs[torch.where(masks, poss, B * S)] = quads
    return fwd.ivals, fwd.infos, ctl, bufs[: B * S].reshape(-1)


def pack_call_words(call_x, call_start, call_len, L: int) -> torch.Tensor:
    """One word per forward call: int32 x<<16 | start<<8 | len when the
    padded read length L is under 64 Ki, else int64 x<<42 | start<<21 |
    len (21-bit fields: _pad_batch refuses reads of 2 Mbp or more).
    start/len <= F_CAP <= 255 on every lane that does not overflow;
    overflow lanes are clamped in the narrow form (their reads go to the
    host engine)."""
    if L < (1 << 16):
        return ((call_x << 16) | (call_start.clamp(max=255) << 8)
                | call_len.clamp(max=255))
    i64 = torch.int64
    return ((call_x.to(i64) << 42) | (call_start.to(i64) << 21)
            | call_len.to(i64))


def unpack_call_words(w: np.ndarray) -> np.ndarray:
    """pack_call_words' words (int32 or int64) -> (n, 3) int64 [x, start,
    len]."""
    if w.dtype == np.int32:
        wu = w.view(np.uint32).astype(np.int64)
        return np.stack([wu >> 16, (wu >> 8) & 0xFF, wu & 0xFF], axis=1)
    M21 = (1 << 21) - 1
    return np.stack([w >> 42, (w >> 21) & M21, w & M21], axis=1)


def _pull_p1p3(ctl_d, bufs_d, B, est_state=None):
    """Pull the fused pass-1/pass-3 results: one speculative prefix pull of
    the control buffer (counts ++ call words, sized from the previous
    batch; a short guess costs one more pull) and an asynchronous pull of
    the seed quads, consumed after the backward. Returns (counts,
    fallback, ncl, calls_np (e1, 3) int64 [x, start, len], n3 (B,)
    clamped, seeds_thunk -> (e3, 4) int64)."""
    hdr = 4 * B
    est = (est_state or {}).get("e1", 12 * B)
    got = pull_prefix(ctl_d, hdr + est)
    counts = got[:hdr].reshape(B, 4).astype(np.int32)
    fallback = counts[:, 0] != 0
    ncl = np.minimum(counts[:, 1].astype(np.int64), seeding.C_CAP)
    n3 = np.minimum(counts[:, 3].astype(np.int64), seeding.S3_CAP)
    e1, e3 = int(ncl.sum()), int(n3.sum())
    if est_state is not None:
        est_state["e1"] = max(1024, (1 << (hdr + e1 - 1).bit_length()) - hdr)
    seeds_raw = pull_prefix_async(bufs_d, 4 * e3)
    if e1 > est:
        got = pull_prefix(ctl_d, hdr + e1)
    calls_np = unpack_call_words(got[hdr: hdr + e1])
    return (counts, fallback, ncl, calls_np, n3,
            lambda: seeds_raw().reshape(e3, 4))


class DeviceSeeder:
    """collect_intv over batches using the device automata."""

    def __init__(self, dfm, opt):
        self.dfm = dfm
        self.opt = opt
        # stage seconds, and counts: "bwd_segments" (host reads of the
        # backward), "bwd_rounds" (the pass kernel's rounds), "v8_redo"
        # (v8 passes redone on the flat engine), "p2_spec"/"p2_redo" (pass
        # 2 on the speculative route / redone on the synchronous one)
        self.times: dict = {}
        self._e1_est: dict = {}
        self._p2_est: dict = {}  # "e": pass 2's entries in the last batch
        self.last_qd = None

    def _mark(self, name, t0):
        self.times[name] = self.times.get(name, 0.0) + time.time() - t0
        return time.time()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dfm.device)

    def _lanes(self, qd, arr: np.ndarray, NLp: int):
        """The lane tables of call rows arr padded to NLp lanes, on the
        device: (read rows, (lane_row, lane_tbl), x0, minv, entries)."""
        lane_row, lane_tbl, x0, minv, e = _lane_tables(arr, NLp)
        lrow_d = self._upload(lane_row)
        return (qd[lrow_d.long()], (lrow_d, self._upload(lane_tbl)), x0,
                minv, e)

    def _run_backward_for_calls(self, qd, call_list, ivals_dev, infos_dev,
                                fallback, fb_map=None):
        """call_list: (row, push_start, push_len, x, min_intv) per lane; row
        indexes rows of qd/ivals_dev. Heavy arrays stay on the device; only
        lane tables cross the host link. Returns per-lane mem lists and
        marks the fallback reads of overflowing lanes."""
        N = len(call_list)
        if N == 0:
            return []
        engine = _backward_engine(self.dfm)
        arr = np.asarray(call_list, dtype=np.int64)  # (n, 5)
        if engine in ("pallas", "pallas_interp"):
            return self._run_backward_fused(qd, arr, ivals_dev, infos_dev,
                                            engine == "pallas_interp")
        NLp = _v8_lanes(N) if engine == "v8" else SF._pad_cap(N)
        qrows, tables, x0, minv, e = self._lanes(qd, arr, NLp)
        if engine == "contig":
            cols = SF.assemble_cols(ivals_dev, infos_dev, *tables,
                                    SF._pad2(SF._pad_cap(e)))
            mems, overflow = SF.run_backward_contig(
                self.dfm, qrows, cols, NLp, x0, minv, stats=self.times)
        else:
            entries = SF.assemble_entries(
                ivals_dev, infos_dev, *tables,
                B8.cap_bucket(e, 1024) if engine == "v8" else SF._pad_cap(e))
            if engine == "v8":
                mems, overflow = v8_cuda.v8_pass_kernel(
                    self.dfm, qrows, entries, NLp, x0, minv,
                    min_len=self.opt.min_seed_len, stats=self.times,
                    max_len=int(arr[:, 2].max()))
                if overflow.any():  # an accumulator filled: redo exactly
                    self.times["v8_redo"] = self.times.get("v8_redo", 0) + 1
                    engine = "flat"
            if engine == "flat":
                mems, overflow = SF.run_backward_flat(
                    self.dfm, qrows, entries, NLp, x0, minv,
                    stats=self.times)
        for ln in np.nonzero(overflow[:N])[0]:
            row = call_list[ln][0]
            fallback[fb_map[row] if fb_map is not None else row] = True
        return mems[:N]

    def _run_backward_fused(self, qd, arr, ivals_dev, infos_dev,
                            interpret: bool, raw: bool = False):
        """The backward pass of every lane of arr ((N, 5) call rows) as
        fused rounds over one flat state at its real length: no padding of
        lanes or entries, and no overflow (a mem lives in its own entry).
        Per-lane mem lists, or with raw=True (the rows of the mems at least
        min_seed_len long, False) as _backward_rows returns them."""
        from mpibwa_tpu_torch.ops import bwd_cuda

        N = arr.shape[0]
        lane_off = np.zeros(N + 1, np.int64)
        np.cumsum(arr[:, 2], out=lane_off[1:])
        e = int(lane_off[-1])
        if e >= 2**31:
            raise ValueError("backward pass of 2**31 or more entries")
        lane_tbl = np.stack([arr[:, 1], arr[:, 2], lane_off[:-1]],
                            axis=1).astype(np.int32)
        lrow_d = self._upload(arr[:, 0].astype(np.int32))
        entries = SF.assemble_entries(ivals_dev, infos_dev, lrow_d,
                                      self._upload(lane_tbl), e)
        out = bwd_cuda.run_backward_fused(
            self.dfm, qd[lrow_d.long()], entries, N, arr[:, 3], arr[:, 4],
            lane_off, interpret=interpret, stats=self.times, raw=raw,
            min_len=self.opt.min_seed_len if raw else 0)
        return out if raw else out[0]

    def _forward1(self, qd, lensd, B):
        """Pass-1 forward (+ pass 3 when max_mem_intv > 0). Returns (ivals,
        infos, fallback, ncl, calls_np, p3_sparse)."""
        opt = self.opt
        if opt.max_mem_intv > 0:
            ivals1, infos1, ctl_d, bufs_d = _fused_p1_p3(
                self.dfm, qd, lensd, opt.min_seed_len, opt.max_mem_intv)
            counts, fallback, ncl, calls_np, n3_all, seeds_thunk = \
                _pull_p1p3(ctl_d, bufs_d, B, self._e1_est)
            return (ivals1, infos1, fallback, ncl, calls_np,
                    (counts[:, 2], n3_all, seeds_thunk))
        min1 = torch.ones(B, dtype=torch.int64, device=qd.device)
        fwd = fwd_cuda.forward_pass_kernel(self.dfm, qd, lensd, min1, True)
        packed = _pack_fwd(fwd).cpu().numpy()
        C = (packed.shape[1] - 2) // 3
        fallback = packed[:, 0] != 0
        ncl = np.minimum(packed[:, 1].astype(np.int64), C)
        b_ = np.repeat(np.arange(B, dtype=np.int64), ncl)
        base = np.zeros(B, np.int64)
        np.cumsum(ncl[:-1], out=base[1:])
        c_ = np.arange(len(b_), dtype=np.int64) - base[b_]
        calls_np = np.stack(
            [packed[b_, 2 + c_], packed[b_, 2 + C + c_],
             packed[b_, 2 + 2 * C + c_]], axis=1).astype(np.int32)
        return fwd.ivals, fwd.infos, fallback, ncl, calls_np, None

    def collect_batch(self, qs, sort: bool = True
                      ) -> Tuple[List[Optional[List[tuple]]], np.ndarray]:
        """Returns (per-read interval lists, fallback_mask) for the reads
        qs (as _pad_batch takes them). Lists are None for reads needing
        host fallback. sort=False returns the pre-sort pass order."""
        t0 = time.time()
        opt = self.opt
        B = len(qs)
        q, lens = _pad_batch(qs)
        qd = self._upload(q)
        self.last_qd = qd  # reused by the extension coordinate kernels
        lensd = self._upload(lens)

        # ---- pass 1 forward (+ pass 3, fused) ----
        ivals1, infos1, fallback, ncl, calls_np, p3_sparse = \
            self._forward1(qd, lensd, B)
        t0 = self._mark("fwd1", t0)
        b_of = np.repeat(np.arange(B, dtype=np.int64), ncl)
        lanes1 = np.stack(
            [b_of, calls_np[:, 1].astype(np.int64),
             calls_np[:, 2].astype(np.int64),
             calls_np[:, 0].astype(np.int64),
             np.ones(len(b_of), np.int64)], axis=1)
        mems_l1 = self._run_backward_for_calls(qd, lanes1, ivals1, infos1,
                                               fallback)
        t0 = self._mark("bwd1", t0)
        pass1 = [[] for _ in range(B)]
        for ln, lane in enumerate(lanes1):
            b = lane[0]
            # emission order is start-descending; reverse per call
            for iv in reversed(mems_l1[ln]):
                slen = (iv[3] & 0xFFFFFFFF) - (iv[3] >> 32)
                if slen >= opt.min_seed_len:
                    pass1[b].append(iv)

        # ---- pass 2: re-seed long low-occ SMEMs from their midpoint ----
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        lanes2 = []  # (read, start_x, min_intv)
        for b in range(B):
            for iv in pass1[b]:
                start, end = iv[3] >> 32, iv[3] & 0xFFFFFFFF
                if end - start < split_len or iv[2] > opt.split_width:
                    continue
                lanes2.append((b, (start + end) >> 1, iv[2] + 1))
        pass2 = [[] for _ in range(B)]
        if lanes2:
            B2 = 1 << max(4, (len(lanes2) - 1).bit_length())
            q2 = np.full((B2, q.shape[1]), 4, dtype=np.uint8)
            starts2 = np.zeros(B2, dtype=np.int32)
            min2 = np.ones(B2, dtype=np.int64)
            lens2 = np.zeros(B2, dtype=np.int32)
            for ln, (b, x, mi) in enumerate(lanes2):
                q2[ln] = q[b]
                lens2[ln] = lens[b]
                starts2[ln] = x
                min2[ln] = mi
            q2d = self._upload(q2)
            fwd2 = fwd_cuda.forward_pass_kernel(
                self.dfm, q2d, self._upload(lens2), self._upload(min2),
                False, self._upload(starts2))
            p2 = _pack_fwd1(fwd2).cpu().numpy()
            for ln in np.nonzero(p2[:, 0])[0]:
                if ln < len(lanes2):
                    fallback[lanes2[ln][0]] = True
            lanes2b = []
            lane2_src = []
            for ln in range(len(lanes2)):
                if p2[ln, 1] == 0:
                    continue  # ambiguous start: no mems
                lanes2b.append((ln, p2[ln, 3], p2[ln, 4], p2[ln, 2],
                                lanes2[ln][2]))
                lane2_src.append(lanes2[ln][0])
            fb_map = {ln: lanes2[ln][0] for ln in range(len(lanes2))}
            mems_l2 = self._run_backward_for_calls(q2d, lanes2b, fwd2.ivals,
                                                   fwd2.infos, fallback,
                                                   fb_map)
            for k, b in enumerate(lane2_src):
                for iv in reversed(mems_l2[k]):
                    slen = (iv[3] & 0xFFFFFFFF) - (iv[3] >> 32)
                    if slen >= opt.min_seed_len:
                        pass2[b].append(iv)
        t0 = self._mark("pass2", t0)

        # ---- pass 3 (computed in the fused pass-1 loop) ----
        pass3_out = [[] for _ in range(B)]
        if p3_sparse is not None:
            ov3, n3, seeds_thunk = p3_sparse
            seeds_np = seeds_thunk()
            for b in np.nonzero(ov3)[0]:
                fallback[b] = True
            read3 = np.repeat(np.arange(B, dtype=np.int64), n3)
            for j in range(len(seeds_np)):
                b = read3[j]
                if fallback[b]:
                    continue  # overflowed rows (n3 > capacity) go scalar
                pass3_out[b].append(tuple(int(v) for v in seeds_np[j]))
        t0 = self._mark("pass3", t0)
        out: List[Optional[List[tuple]]] = []
        for b in range(B):
            if fallback[b]:
                out.append(None)
                continue
            mem = pass1[b] + pass2[b] + pass3_out[b]
            if sort:
                ks_introsort(mem, lambda a, c: a[3] < c[3])
            out.append(mem)
        self._mark("sortout", t0)
        return out, fallback

    # -- arrays-end-to-end path -----------------------------------------------

    def _backward_rows(self, qd, call_list, ivals_dev, infos_dev):
        """Backward as rows: ((n, 6) [x0, x1, x2, start, end, lane]
        min_len-filtered, chronological within lane; overflow bool). v8 and
        the pass engine filter and compact the rows on the device; flat and
        contig go through per-lane lists."""
        N = len(call_list)
        if N == 0:
            return np.zeros((0, 6), np.int32), False
        engine = _backward_engine(self.dfm)
        arr = np.asarray(call_list, dtype=np.int64)
        if engine in ("pallas", "pallas_interp"):
            return self._run_backward_fused(qd, arr, ivals_dev, infos_dev,
                                            engine == "pallas_interp",
                                            raw=True)
        if engine == "v8":
            NLp = _v8_lanes(N)
            qrows, tables, x0, minv, e = self._lanes(qd, arr, NLp)
            entries = SF.assemble_entries(ivals_dev, infos_dev, *tables,
                                          B8.cap_bucket(e, 1024))
            return v8_cuda.v8_pass_kernel(
                self.dfm, qrows, entries, NLp, x0, minv,
                min_len=self.opt.min_seed_len, raw=True,
                est_rows=N // 8 + 1024, stats=self.times,
                max_len=int(arr[:, 2].max()))
        fb = np.zeros(1 + int(arr[:, 0].max()), bool)
        mems = self._run_backward_for_calls(qd, call_list, ivals_dev,
                                            infos_dev, fb)
        if fb.any():
            return np.zeros((0, 6), np.int32), True
        rows = []
        msl = self.opt.min_seed_len
        for ln, mem in enumerate(mems):
            for iv in mem:
                st, en = iv[3] >> 32, iv[3] & 0xFFFFFFFF
                if en - st >= msl:
                    rows.append((iv[0], iv[1], iv[2], st, en, ln))
        return (np.array(rows, self.dfm.np_idt).reshape(-1, 6)
                if rows else np.zeros((0, 6), np.int32)), False

    @staticmethod
    def _order_rows(rows):
        """(lane asc, chronological desc): the per-lane reversal of the
        list path, vectorized."""
        if len(rows) == 0:
            return rows
        order = np.lexsort((-np.arange(len(rows)), rows[:, 5]))
        return rows[order]

    def collect_flat(self, qs):
        """Arrays-end-to-end collect_intv over the reads qs (as _pad_batch
        takes them): (flat (M, 4) int64 rows in pre-sort pass order,
        mem_off int64[B+1], fallback (B,) bool), or None on a backward
        overflow (the caller takes the list path). Row-for-row equal to
        the packed collect_batch(sort=False)."""
        t0 = time.time()
        opt = self.opt
        B = len(qs)
        q, lens = _pad_batch(qs)
        qd = self._upload(q)
        self.last_qd = qd
        lensd = self._upload(lens)

        ivals1, infos1, fallback, ncl, calls_np, p3_sparse = \
            self._forward1(qd, lensd, B)
        t0 = self._mark("fwd1", t0)
        b_of = np.repeat(np.arange(B, dtype=np.int64), ncl)
        lanes1 = np.stack(
            [b_of, calls_np[:, 1].astype(np.int64),
             calls_np[:, 2].astype(np.int64),
             calls_np[:, 0].astype(np.int64),
             np.ones(len(b_of), np.int64)], axis=1)
        rows1, ov1 = self._backward_rows(qd, lanes1, ivals1, infos1)
        if ov1:
            return None
        t0 = self._mark("bwd1", t0)
        rows1 = self._order_rows(rows1)
        read1 = (lanes1[:, 0][rows1[:, 5]] if len(rows1)
                 else np.zeros(0, np.int64))

        # ---- pass 2 (selection over pass-1 rows in iteration order) ----
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        sel = ((rows1[:, 4] - rows1[:, 3] >= split_len)
               & (rows1[:, 2] <= opt.split_width)) if len(rows1) else \
            np.zeros(0, bool)
        rows2 = np.zeros((0, 6), np.int32)
        read2 = np.zeros(0, np.int64)
        if sel.any():
            srows = rows1[sel]
            sreads = read1[sel]
            n2 = len(srows)
            B2 = 1 << max(4, (n2 - 1).bit_length())
            # the sub-batch is built on the device from the rows of qd
            row_idx = np.zeros(B2, np.int64)
            row_idx[:n2] = sreads
            valid2 = np.zeros(B2, bool)
            valid2[:n2] = True
            lens2 = np.zeros(B2, np.int32)
            lens2[:n2] = lens[sreads]
            starts2 = np.zeros(B2, np.int32)
            starts2[:n2] = (srows[:, 3] + srows[:, 4]) >> 1
            min2 = np.ones(B2, np.int64)
            min2[:n2] = srows[:, 2].astype(np.int64) + 1
            q2d = torch.where(self._upload(valid2)[:, None],
                              qd[self._upload(row_idx)], 4).to(torch.uint8)
            t2 = time.time()
            fwd2 = fwd_cuda.forward_pass_kernel(
                self.dfm, q2d, self._upload(lens2), self._upload(min2),
                False, self._upload(starts2))
            done2 = False
            if _backward_engine(self.dfm) == "v8" and "e" in self._p2_est:
                # speculative route: lane tables on the device at a
                # capacity learned from the batches before, the control
                # vector pulled after the backward; a capacity miss raises
                # the backward's overflow and the synchronous route below
                # redoes pass 2 with the same forward
                cap = B8.cap_bucket(max(self._p2_est["e"] * 5 // 4, 1024),
                                    1024)
                ltbl_d, x0_d, ctl2_d, cap_ov = _p2_tables(fwd2, cap)
                entries2 = SF.assemble_entries(
                    fwd2.ivals, fwd2.infos,
                    torch.arange(B2, dtype=torch.int32, device=q2d.device),
                    ltbl_d, cap)
                ctl2_thunk = pull_prefix_async(ctl2_d, 1 + n2)
                t2 = self._mark("p2_fwd", t2)
                rows2, ov2 = v8_cuda.v8_pass_kernel(
                    self.dfm, q2d, entries2, B2, x0_d,
                    self._upload(min2.astype(np.int32)),
                    min_len=opt.min_seed_len, raw=True,
                    est_rows=B2 // 8 + 1024, extra_ov=cap_ov,
                    stats=self.times)
                t2 = self._mark("p2_bwd", t2)
                ctl2 = ctl2_thunk()
                self._p2_est["e"] = max(int(ctl2[0]), 64)
                done2 = not ov2
                key = "p2_spec" if done2 else "p2_redo"
                self.times[key] = self.times.get(key, 0) + 1
                if done2:
                    ovl = ctl2[1: 1 + n2] != 0
                    if ovl.any():
                        fallback[sreads[ovl]] = True
                    rows2 = self._order_rows(rows2)
                    read2 = (sreads[rows2[:, 5]] if len(rows2)
                             else np.zeros(0, np.int64))
            if not done2:
                p2 = _pack_fwd1(fwd2).cpu().numpy()
                t2 = self._mark("p2_fwd", t2)
                ovl = p2[:n2, 0] != 0
                if ovl.any():
                    fallback[sreads[ovl]] = True
                # lanes whose forward overflowed need no backward: their
                # reads go to the host engine
                live2 = (p2[:n2, 1] > 0) & ~ovl
                self._p2_est["e"] = max(int(p2[:n2, 4][live2].sum()), 64)
                l2idx = np.nonzero(live2)[0]
                if len(l2idx):
                    call_list2 = np.stack(
                        [l2idx, p2[l2idx, 3], p2[l2idx, 4], p2[l2idx, 2],
                         min2[l2idx]], axis=1)
                    rows2, ov2 = self._backward_rows(q2d, call_list2,
                                                     fwd2.ivals, fwd2.infos)
                    self._mark("p2_bwd", t2)
                    if ov2:
                        return None
                    rows2 = self._order_rows(rows2)
                    read2 = (sreads[l2idx[rows2[:, 5]]] if len(rows2)
                             else np.zeros(0, np.int64))
        t0 = self._mark("pass2", t0)

        # ---- pass 3 rows ----
        rows3 = np.zeros((0, 4), np.int64)
        read3 = np.zeros(0, np.int64)
        if p3_sparse is not None:
            ov3, n3, seeds_thunk3 = p3_sparse
            fallback |= ov3 != 0
            seeds_np = seeds_thunk3()  # the copy overlapped the backward
            if len(seeds_np):
                read3 = np.repeat(np.arange(B, dtype=np.int64), n3)
                keep3 = ~fallback[read3]
                read3 = read3[keep3]
                rows3 = seeds_np[keep3]
        t0 = self._mark("pass3", t0)

        # ---- combine per read: pass order within read, no sort ----
        def to4(rows):
            out = np.empty((len(rows), 4), np.int64)
            out[:, 0] = rows[:, 0]
            out[:, 1] = rows[:, 1]
            out[:, 2] = rows[:, 2]
            out[:, 3] = (rows[:, 3].astype(np.int64) << 32) | rows[:, 4]
            return out

        flat = np.concatenate([to4(rows1), to4(rows2), rows3], axis=0)
        reads = np.concatenate([read1, read2, read3])
        ranks = np.concatenate(
            [np.zeros(len(read1), np.int64),
             np.ones(len(read2), np.int64),
             np.full(len(read3), 2, np.int64)])
        keep = ~fallback[reads] if len(reads) else np.zeros(0, bool)
        flat, reads, ranks = flat[keep], reads[keep], ranks[keep]
        order = np.argsort(reads * 4 + ranks, kind="stable")
        flat = flat[order]
        reads = reads[order]
        mem_off = np.searchsorted(reads, np.arange(B + 1, dtype=np.int64))
        self._mark("sortout", t0)
        return flat, mem_off.astype(np.int64), fallback
