"""Device-accelerated alignment pipeline on torch tensors.

Counterpart of mpibwa_tpu/pipeline/device_align.py. Flow per microbatch:
  1. device: SMEM seeding (pipeline/device_seed.py)
  2. device: batched SA resolution (ops/fmd.py sa_lookup)
  3. host C runtime: chaining, chain filtering, regions
     (native/finalize.c through pipeline/native_final.NativeChainer)
  4. device: banded extension DP (the CUDA kernel, ops/extend_cuda.py)
     when MPIBWA_EXT=device, else scalar in C
  5. host C runtime: finalization to SAM text

A backward overflow in seeding sends the microbatch to the list route:
the exact collect_batch, Python chaining with every extension batched on
the device (_precompute_extensions), then C finalization.

Without the C runtime (no C compiler, MPIBWA_NATIVE=0 or
MPIBWA_FINAL=python) every microbatch takes the list route and the chunk
is finalized by the Python record route of core/: the first-round global
alignment of every region (its CIGAR) is batched on the device
(precompute_cigars, ops/global_batch.py), and for PE every mate-rescue SW
the pairing can ask for (precompute_rescue, ops/rescue.py); core/cigar
and core/pair serve them from caches and run the scalar kernels on a
miss. MPIBWA_CHAIN=python keeps C finalization but chains in Python (the
list route).
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from mpibwa_tpu_torch.core import opts as O
from mpibwa_tpu_torch.core import region as R
from mpibwa_tpu_torch.core.chain import (mem_chain, mem_chain_flt,
                                   mem_flt_chained_seeds)
from mpibwa_tpu_torch.core.extend import ksw_extend2
from mpibwa_tpu_torch.core.fm import FMIndex
from mpibwa_tpu_torch.core.pipeline import BSeq, mem_align1_core
from mpibwa_tpu_torch.core.refseq import RefSeq
from mpibwa_tpu_torch.core.region import (cal_max_gap, mem_mark_primary_se,
                                          mem_reorder_primary5,
                                          mem_sort_dedup_patch)
from mpibwa_tpu_torch.core.sam import mem_reg2sam
from mpibwa_tpu_torch.io.columns import columns_of, seq_source
from mpibwa_tpu_torch.pipeline.native_final import NativeChainer
from mpibwa_tpu_torch.ops.extend_batch import extend_from_coords
from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder, _pad_batch


def _round_up(x: int, buckets) -> int:
    for b in buckets:
        if x <= b:
            return b
    return buckets[-1]


def _ext_device() -> bool:
    """MPIBWA_EXT=device runs the extension DP on the device; native (the
    default) and auto leave every DP of the native route to C."""
    return os.environ.get("MPIBWA_EXT", "native") not in ("native", "auto")


class _ExtCache:
    """Serves precomputed ksw_extend2 results; falls back to scalar."""

    def __init__(self, opt):
        self.opt = opt
        self.cache: Dict[tuple, tuple] = {}
        self.misses = 0

    def __call__(self, qs, ts, w, eb, zd, h0):
        r = self.cache.get((qs.tobytes(), ts.tobytes(), w, eb, zd, h0))
        if r is not None:
            return r
        self.misses += 1
        opt = self.opt
        return ksw_extend2(qs, ts, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
                           opt.e_ins, w, eb, zd, h0)


class _RangeChainer(NativeChainer):
    """The C chain stage, handing each C session its own reads.

    NativeChainer.run chains a large microbatch as concurrent C sessions
    over read ranges, and each session numbers its reads from 0, so the
    row of an extension problem indexes the reads of its session, not the
    microbatch. (mpibwa_tpu gathers those rows from the whole microbatch,
    which is wrong for every range after the first; see ROADMAP.md.) The
    extension callback here receives the session's reads with the
    problems."""

    def _run_range(self, seqs, mems_flat, mem_off, resolve_sa, ext_rows,
                   max_subset):
        return super()._run_range(seqs, mems_flat, mem_off, resolve_sa,
                                  functools.partial(ext_rows, seqs=seqs),
                                  max_subset)


class DeviceAligner:
    """mem_process_seqs with the hot loops on a torch device."""

    Q_BUCKETS = (64, 128, 192, 256, 512)
    T_BUCKETS = (128, 256, 384, 512, 768, 1024)
    MAX_SEEDS_PER_CHAIN = 8  # optimistic extension cap; rest -> scalar
    MICROBATCH = int(os.environ.get("MPIBWA_MICROBATCH", "16384"))

    def __init__(self, idx, opt, device=None, dfm=None, fm=None, refs=None):
        """device: torch device (default: resolve_device()); dfm: share a
        DeviceFMIndex between aligners on one device; fm/refs: share the
        host engines the same way."""
        from mpibwa_tpu_torch.device import resolve_device

        self.opt = opt
        self.fm = fm if fm is not None else FMIndex.from_index(idx)
        self.refs = refs if refs is not None else RefSeq(idx)
        if dfm is None:
            dfm = DeviceFMIndex(idx, resolve_device(device))
        self.dfm = dfm
        self.device = dfm.device
        self.seeder = DeviceSeeder(self.dfm, opt)
        # overflow_batches: microbatches that took the list route;
        # cigar_problems / rescue_problems: the record route's device DPs;
        # packed_reads / looped_reads: reads the C finalize took, their
        # blobs sliced from the batch's columns / joined read by read
        self.stats = {"fallback_reads": 0, "ext_problems": 0, "ext_misses": 0,
                      "overflow_batches": 0, "cigar_problems": 0,
                      "rescue_problems": 0, "packed_reads": 0,
                      "looped_reads": 0, "t": {}}
        self.mat55d = torch.from_numpy(
            opt.mat.reshape(5, 5).astype(np.int32)).to(self.device)
        self._qd = None  # device read batch of the list route's microbatch
        self._finalizer = None
        self._chainer = None

    def _native_finalizer(self):
        """The C finalization runtime, or None (no C runtime, or
        MPIBWA_FINAL=python): then the Python record route."""
        if self._finalizer is None:
            from mpibwa_tpu_torch.pipeline.native_final import NativeFinalizer

            self._finalizer = NativeFinalizer(self.refs, self.opt)
        return self._finalizer if self._finalizer.available else None

    def _native_chainer(self):
        """The C chain stage, or None without the C runtime or when
        MPIBWA_CHAIN selects Python chaining (then every microbatch takes
        the list route)."""
        fin = self._native_finalizer()
        if fin is None:
            return None
        if self._chainer is None:
            self._chainer = _RangeChainer(fin)
        return self._chainer if self._chainer.available else None

    def _count_packing(self, seqs):
        """Count seqs under the route NativeFinalizer._pack_blobs took."""
        key = ("packed_reads" if columns_of(seqs) is not None
               else "looped_reads")
        self.stats[key] += len(seqs)

    def _finalize_in_c(self, fin, seqs, *args) -> bool:
        """fin.finalize(seqs, *args), counting seqs when it wrote their
        SAM text; False without fin."""
        if fin is None or not fin.finalize(seqs, *args):
            return False
        self._count_packing(seqs)
        return True

    def _add_time(self, name, t0):
        t = self.stats["t"]
        t[name] = t.get(name, 0.0) + time.time() - t0

    # -- native-chain driver --------------------------------------------------

    def _sa_flat(self, ks):
        if len(ks) == 0:
            return np.zeros(0, np.int64)
        got = self.dfm.sa_lookup(torch.from_numpy(
            np.ascontiguousarray(ks, dtype=np.int64)).to(self.device))
        return got.cpu().numpy().astype(np.int64)

    def _sa_prefetch(self, mems_flat):
        """Start the SA walk for the whole microbatch before the C chain
        session, so the device resolves positions while C chains.

        fin_chain_begin enumerates SA indices k = x0 + j*step per interval
        (bwamem.c mem_chain sampling), which depends only on the interval
        rows, so the superset over the unsorted rows equals the set C asks
        for. Returns a resolve(ks) closure serving from the prefetched
        table; a position outside it falls back to a direct walk."""
        if len(mems_flat) == 0:
            return self._sa_flat
        x0 = mems_flat[:, 0]
        x2 = mems_flat[:, 2]
        mo = int(self.opt.max_occ)
        step = np.where(x2 > mo, x2 // mo, 1)
        cnt = np.minimum((x2 + step - 1) // step, mo)
        off = np.zeros(len(cnt) + 1, np.int64)
        np.cumsum(cnt, out=off[1:])
        total = int(off[-1])
        j = np.arange(total, dtype=np.int64) - np.repeat(off[:-1], cnt)
        upos = np.unique(np.repeat(x0, cnt) + np.repeat(step, cnt) * j)
        n = len(upos)
        vals_dev = self.dfm.sa_lookup(torch.from_numpy(upos).to(self.device))
        state = {}
        lock = threading.Lock()

        def resolve(ks):
            ks = np.asarray(ks, dtype=np.int64)
            if len(ks) == 0:
                return np.zeros(0, np.int64)
            with lock:  # concurrent chain ranges share one table
                if "vals" not in state:
                    state["vals"] = vals_dev.cpu().numpy().astype(np.int64)
            idx = np.minimum(np.searchsorted(upos, ks), n - 1)
            out = state["vals"][idx]
            miss = upos[idx] != ks
            if miss.any():
                out[miss] = self._sa_flat(ks[miss])
            return out

        return resolve

    def _ext_rows_run(self, qd, c, p, maxq, maxt) -> np.ndarray:
        """Run B extension problems on the device: c (B, 6) coordinate rows
        into the read batch qd, p (B, 4) params -> (B, 6) int32 [score, qle,
        tle, gtle, gscore, max_off]. Problems are padded to a power of two
        and sorted by target length so the kernel's warps finish
        together."""
        opt = self.opt
        B = len(c)
        Q = _round_up(maxq, self.Q_BUCKETS)
        T = _round_up(maxt, self.T_BUCKETS)
        Bp = 1 << max(4, (B - 1).bit_length())
        cc = np.zeros((Bp, 6), np.int64)  # int64: r_start is a doubled coord
        pp = np.zeros((Bp, 4), np.int32)
        pp[:, 3] = 1  # dummy h0 > 0
        cc[:, 2] = 1  # dummy qlen
        cc[:B] = c
        pp[:B] = p
        order = np.argsort(cc[:B, 5], kind="stable")
        cc[:B] = cc[:B][order]
        pp[:B] = pp[:B][order]
        dev = self.device
        out = extend_from_coords(self.dfm, qd,
                                 torch.from_numpy(cc).to(dev), Q, T,
                                 torch.from_numpy(pp).to(dev), opt.o_del,
                                 opt.e_del, opt.o_ins, opt.e_ins, self.mat55d)
        res = torch.stack(list(out), dim=1).cpu().numpy()
        inv = np.empty(B, np.int64)
        inv[order] = np.arange(B)
        return res[inv]

    def _ext_rows(self, coords, params, seqs):
        """Device extension rounds for a C chain session over reads seqs:
        returns ((B, 12) int32 [r0|r1] rows, (B,) uint8 has-bits). Problems
        beyond the bucket ladder get no bits: C runs the scalar kernel for
        them, as it does for every problem unless MPIBWA_EXT=device."""
        B = len(coords)
        out_r = np.zeros((B, 12), np.int32)
        has = np.zeros(B, np.uint8)
        if B == 0 or not _ext_device():
            return out_r, has
        qcap, tcap = self.Q_BUCKETS[-1], self.T_BUCKETS[-1]
        small = np.nonzero((coords[:, 2] <= qcap)
                           & (coords[:, 5] <= tcap))[0]
        if len(small) == 0:
            return out_r, has
        self.stats["ext_problems"] += int(len(small))
        c = coords[small]
        p = params[small]
        maxq = int(c[:, 2].max())
        maxt = max(int(c[:, 5].max()), 1)
        # both band tries (w and w<<1) ride one device call
        p1 = p.copy()
        p1[:, 0] = self.opt.w << 1
        qd = torch.from_numpy(_pad_batch(seq_source(seqs))[0]).to(
            self.device)
        both = self._ext_rows_run(qd, np.concatenate([c, c]),
                                  np.concatenate([p, p1]), maxq, maxt)
        n = len(small)
        out_r[small, :6] = both[:n]
        out_r[small, 6:] = both[n:]
        has[small] = 3
        return out_r, has

    def _seed_stage(self, seqs):
        """Device phase of one microbatch: seeding rows + the SA prefetch.
        Runs on a helper thread in align_arrays so the next microbatch's
        device work overlaps this one's C chain session. Returns (rows,
        resolve), or None on a backward overflow."""
        t0 = time.time()
        got = self.seeder.collect_flat(seq_source(seqs))
        if got is None:
            return None
        resolve = self._sa_prefetch(got[0])
        self._add_time("seed", t0)
        return got, resolve

    def _align_arrays_inner(self, seqs, chainer, staged):
        """Native-chain microbatch: (regs packed array, reg_off) or None."""
        got, resolve = staged
        mems_flat, mem_off, fallback = got
        self.stats["fallback_reads"] += int(fallback.sum())
        t0 = time.time()
        res = chainer.run(seqs, (mems_flat, mem_off), resolve,
                          self._ext_rows, self.MAX_SEEDS_PER_CHAIN)
        if res is None:
            return None
        regs, reg_off = res
        fb = list(np.nonzero(fallback)[0])
        if fb:
            from mpibwa_tpu_torch.pipeline.native_final import regs_to_array

            lists = {b: mem_align1_core(self.opt, self.fm, self.refs,
                                        seqs[b].seq) for b in fb}
            counts = np.diff(reg_off)
            for b in fb:
                counts[b] = len(lists[b])
            new_off = np.zeros(len(seqs) + 1, np.int64)
            np.cumsum(counts, out=new_off[1:])
            new_regs = np.zeros(int(new_off[-1]), regs.dtype)
            for b in range(len(seqs)):
                if b in lists:
                    arr, _ = regs_to_array([lists[b]])
                    new_regs[new_off[b]:new_off[b + 1]] = arr
                else:
                    new_regs[new_off[b]:new_off[b + 1]] = \
                        regs[reg_off[b]:reg_off[b + 1]]
            regs, reg_off = new_regs, new_off
        self._add_time("chain", t0)
        return regs, reg_off

    def _microbatches(self, seqs):
        """(real, padded) microbatches: a short tail of at least 256 reads
        is padded with dummy reads to the next power of two (capped at the
        microbatch size). A batch with columns (io/columns.py) gives
        microbatches with theirs."""
        MB = self.MICROBATCH
        subs = []
        for off in range(0, len(seqs), MB):
            sub = seqs[off: off + MB]
            if 0 < len(sub) < MB and len(sub) >= 256:
                cap = 256
                while cap < len(sub):
                    cap <<= 1
                dummy = BSeq(name="__pad__", seq=np.zeros(8, np.uint8),
                             qual="IIIIIIII")
                k = min(cap, MB) - len(sub)
                subs.append((sub, sub.padded(dummy, k)
                             if columns_of(sub) is not None
                             else list(sub) + [dummy] * k))
            else:
                subs.append((sub, sub))
        return subs

    def align_arrays(self, seqs):
        """Microbatched native-chain alignment: packed regions for the
        whole batch, or None -> the caller takes the list route. While the
        C chain session of microbatch i holds the cores (GIL released), a
        helper thread drives microbatch i+1's device seeding; torch calls
        from that thread run on the same device and the host reads
        (.cpu(), .item()) synchronize."""
        chainer = self._native_chainer()
        if chainer is None or not seqs:
            return None
        subs = self._microbatches(seqs)
        parts = []
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(self._seed_stage_on_device, subs[0][1])
            for i, (sub, padded) in enumerate(subs):
                staged = fut.result()
                if i + 1 < len(subs):
                    fut = ex.submit(self._seed_stage_on_device,
                                    subs[i + 1][1])
                if staged is None:
                    fut.result()  # let the running stage finish first
                    return None
                res = self._align_arrays_inner(padded, chainer, staged)
                if res is None:
                    fut.result()
                    return None
                if len(padded) != len(sub):
                    regs, reg_off = res
                    res = (regs[: reg_off[len(sub)]], reg_off[: len(sub) + 1])
                parts.append(res)
        if len(parts) == 1:
            return parts[0]
        regs = np.concatenate([p[0] for p in parts])
        offs = [parts[0][1]]
        base = parts[0][1][-1]
        for p in parts[1:]:
            offs.append(p[1][1:] + base)
            base += p[1][-1]
        return regs, np.concatenate(offs)

    def _seed_stage_on_device(self, seqs):
        # a helper thread starts on the default CUDA device: pin it to ours
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return self._seed_stage(seqs)
        return self._seed_stage(seqs)

    # -- the list route (backward overflow) -----------------------------------

    def _resolve_sa(self, mems_per_read) -> List[Dict[int, int]]:
        opt = self.opt
        ks: List[int] = []
        owners: List[int] = []
        for b, mem in enumerate(mems_per_read):
            if mem is None:
                continue
            for iv in mem:
                step = iv[2] // opt.max_occ if iv[2] > opt.max_occ else 1
                k, count = 0, 0
                while k < iv[2] and count < opt.max_occ:
                    ks.append(iv[0] + k)
                    owners.append(b)
                    k += step
                    count += 1
        caches: List[Dict[int, int]] = [dict() for _ in mems_per_read]
        if not ks:
            return caches
        got = self._sa_flat(np.array(ks, np.int64))
        for b, k, pos in zip(owners, ks, got):
            caches[b][k] = int(pos)
        return caches

    def _ext_coords_run(self, coords, params, maxq, maxt):
        """coords: (B, 6) rows; params: (B, 4). Returns a list of tuples."""
        if len(coords) == 0:
            return []
        res = self._ext_rows_run(self._qd, np.asarray(coords, np.int64),
                                 np.asarray(params, np.int32), maxq, maxt)
        return [tuple(int(v) for v in r) for r in res]

    def _precompute_extensions(self, chains_per_read, qs_per_read,
                               cache: _ExtCache):
        opt = self.opt
        refs = self.refs
        left_jobs = []  # (key_q, key_t, h0, coords-row)
        chain_ctx = []
        for b, chains in enumerate(chains_per_read):
            if chains is None:
                continue
            query = qs_per_read[b]
            l_query = len(query)
            for c in chains:
                if c.n == 0:
                    continue
                l_pac = refs.l_pac
                rmax0, rmax1 = l_pac << 1, 0
                for t in c.seeds:
                    lo = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
                    hi = (t.rbeg + t.len + (l_query - t.qbeg - t.len)
                          + cal_max_gap(opt, l_query - t.qbeg - t.len))
                    rmax0 = min(rmax0, lo)
                    rmax1 = max(rmax1, hi)
                rmax0 = max(rmax0, 0)
                rmax1 = min(rmax1, l_pac << 1)
                if rmax0 < l_pac < rmax1:
                    if c.seeds[0].rbeg < l_pac:
                        rmax1 = l_pac
                    else:
                        rmax0 = l_pac
                rseq, rid, rmax0, rmax1 = refs.fetch_seq(
                    rmax0, c.seeds[0].rbeg, rmax1)
                order = sorted(range(c.n),
                               key=lambda i: (c.seeds[i].score, i),
                               reverse=True)
                subset = order[: self.MAX_SEEDS_PER_CHAIN]
                chain_ctx.append((b, query, rseq, rmax0, rmax1, c, subset))
                for si in subset:
                    s = c.seeds[si]
                    if s.qbeg:
                        tmp = s.rbeg - rmax0
                        qkey = np.ascontiguousarray(
                            query[s.qbeg - 1:: -1]).tobytes()
                        tkey = np.ascontiguousarray(
                            rseq[tmp - 1:: -1] if tmp > 0
                            else rseq[:0]).tobytes()
                        left_jobs.append(
                            (qkey, tkey, s.len * opt.a,
                             (b, 0, s.qbeg, 1, s.rbeg, tmp)))

        def run_band_tries(jobs, eb):
            """jobs: (key_q, key_t, h0, coords). Exact MAX_BAND_TRY loop;
            problems beyond the bucket ladder run the scalar kernel."""
            if not jobs:
                return [], {}
            qcap, tcap = self.Q_BUCKETS[-1], self.T_BUCKETS[-1]
            small = [i for i, j in enumerate(jobs)
                     if j[3][2] <= qcap and j[3][5] <= tcap]
            r0_all = [None] * len(jobs)
            r1map = {}
            if small:
                coords = [jobs[i][3] for i in small]
                maxq = max(c[2] for c in coords)
                maxt = max(max(c[5] for c in coords), 1)
                params = [(opt.w, eb, opt.zdrop, jobs[i][2]) for i in small]
                r0 = self._ext_coords_run(coords, params, maxq, maxt)
                for i, r in zip(small, r0):
                    r0_all[i] = r
                retry_idx = [i for i, r in zip(small, r0)
                             if not (r[5] < (opt.w >> 1) + (opt.w >> 2))]
                if retry_idx:
                    params1 = [(opt.w << 1, eb, opt.zdrop, jobs[i][2])
                               for i in retry_idx]
                    r1 = self._ext_coords_run(
                        [jobs[i][3] for i in retry_idx], params1, maxq, maxt)
                    r1map = dict(zip(retry_idx, r1))
            for i, j in enumerate(jobs):
                if r0_all[i] is not None:
                    continue
                qs = np.frombuffer(j[0], np.uint8)
                ts = np.frombuffer(j[1], np.uint8)
                r0_all[i] = ksw_extend2(qs, ts, opt.mat, opt.o_del,
                                        opt.e_del, opt.o_ins, opt.e_ins,
                                        opt.w, eb, opt.zdrop, j[2])
                if not (r0_all[i][5] < (opt.w >> 1) + (opt.w >> 2)):
                    r1map[i] = ksw_extend2(qs, ts, opt.mat, opt.o_del,
                                           opt.e_del, opt.o_ins, opt.e_ins,
                                           opt.w << 1, eb, opt.zdrop, j[2])
            return r0_all, r1map

        left_r0, left_r1 = run_band_tries(left_jobs, opt.pen_clip5)
        li = 0
        right_jobs = []
        for (b, query, rseq, rmax0, rmax1, c, subset) in chain_ctx:
            l_query = len(query)
            for si in subset:
                s = c.seeds[si]
                sc0 = s.len * opt.a
                if s.qbeg:
                    qk, tk, h0, _ = left_jobs[li]
                    r0 = left_r0[li]
                    cache.cache[(qk, tk, opt.w, opt.pen_clip5, opt.zdrop,
                                 h0)] = r0
                    score = r0[0]
                    if li in left_r1:
                        r1 = left_r1[li]
                        cache.cache[(qk, tk, opt.w << 1, opt.pen_clip5,
                                     opt.zdrop, h0)] = r1
                        score = r1[0]
                    sc0 = score
                    li += 1
                if s.qbeg + s.len != l_query:
                    qe = s.qbeg + s.len
                    re = s.rbeg + s.len - rmax0
                    qkey = np.ascontiguousarray(query[qe:]).tobytes()
                    tkey = np.ascontiguousarray(rseq[re:]).tobytes()
                    right_jobs.append(
                        (qkey, tkey, sc0,
                         (b, qe, l_query - qe, 0, s.rbeg + s.len,
                          rmax1 - (s.rbeg + s.len))))
        right_r0, right_r1 = run_band_tries(right_jobs, opt.pen_clip3)
        for i, (qk, tk, h0, _) in enumerate(right_jobs):
            cache.cache[(qk, tk, opt.w, opt.pen_clip3, opt.zdrop, h0)] = \
                right_r0[i]
            if i in right_r1:
                cache.cache[(qk, tk, opt.w << 1, opt.pen_clip3, opt.zdrop,
                             h0)] = right_r1[i]
        self.stats["ext_problems"] += len(left_jobs) + len(right_jobs)

    def align_regs(self, seqs: List[BSeq], cigar_cache: "dict | None" = None
                   ) -> List[List[R.AlnReg]]:
        """Alignment regions for a batch through the list route, in
        microbatches padded like align_arrays' (per-read regions do not
        depend on the grouping). With cigar_cache, each microbatch's
        first-round global alignments are added to it (precompute_cigars
        on the microbatch's own device rows)."""
        out = []
        for sub, padded in self._microbatches(seqs):
            self.stats["overflow_batches"] += 1
            regs = self._align_regs_inner(padded)
            if cigar_cache is not None:
                t0 = time.time()
                cc = precompute_cigars(self.opt, self.refs,
                                       [s.seq for s in padded], regs,
                                       self.dfm, self._qd, self.mat55d)
                self.stats["cigar_problems"] += len(cc)
                cigar_cache.update(cc)
                self._add_time("cigar", t0)
            out.extend(regs[: len(sub)])
        return out

    def _align_regs_inner(self, seqs: List[BSeq]) -> List[List[R.AlnReg]]:
        opt, fm, refs = self.opt, self.fm, self.refs
        t0 = time.time()
        mems, fallback = self.seeder.collect_batch(seq_source(seqs))
        self._qd = self.seeder.last_qd
        self._add_time("seed", t0)
        self.stats["fallback_reads"] += int(fallback.sum())
        t0 = time.time()
        sa_caches = self._resolve_sa(mems)
        self._add_time("sa", t0)
        t0 = time.time()
        chains_per_read = []
        for b, s in enumerate(seqs):
            if mems[b] is None:
                chains_per_read.append(None)
                continue
            chn = mem_chain(opt, fm, refs, s.seq, s.l_seq, mem=mems[b],
                            sa=lambda k, b=b: sa_caches[b][k])
            chn = mem_chain_flt(opt, chn)
            mem_flt_chained_seeds(opt, refs, s.l_seq, s.seq, chn)
            chains_per_read.append(chn)
        self._add_time("chain", t0)
        t0 = time.time()
        cache = _ExtCache(opt)
        self._precompute_extensions(chains_per_read, [s.seq for s in seqs],
                                    cache)
        self._add_time("ext", t0)
        t0 = time.time()
        regs_all = []
        for b, s in enumerate(seqs):
            if chains_per_read[b] is None:
                regs = mem_align1_core(opt, fm, refs, s.seq)
            else:
                regs: List[R.AlnReg] = []
                for c in chains_per_read[b]:
                    R.mem_chain2aln(opt, refs, s.l_seq, s.seq, c, regs,
                                    extender=cache)
                regs = mem_sort_dedup_patch(opt, refs, s.seq, regs)
                for p in regs:
                    if p.rid >= 0 and refs.anns[p.rid].is_alt:
                        p.is_alt = 1
            regs_all.append(regs)
        self._add_time("final", t0)
        self.stats["ext_misses"] += cache.misses
        return regs_all

    # -- the public entry ----------------------------------------------------

    def _process_seqs_native(self, seqs, n_processed, pes0, rg_id) -> bool:
        """All-native record path: device seeding/SA/extension arrays in,
        SAM text out, with chaining + finalization in C. False -> the list
        route."""
        opt = self.opt
        chainer = self._native_chainer()
        if chainer is None or not seqs:
            return False
        arrays = self.align_arrays(seqs)
        if arrays is None:
            return False
        regs, reg_off = arrays
        t0 = time.time()
        if opt.flag & O.MEM_F_PE:
            from mpibwa_tpu_torch.core.pair import pestat_from_isize

            if pes0 is not None:
                pes = pes0
            else:
                iso = chainer.pestat_isizes(regs, reg_off, opt.max_ins)
                if iso is None:
                    return False
                pes = pestat_from_isize(iso)
            ok = chainer.finalize_packed(seqs, regs, reg_off, True,
                                         n_processed >> 1, rg_id, pes)
        else:
            ok = chainer.finalize_packed(seqs, regs, reg_off, False,
                                         n_processed, rg_id)
        if ok:
            self._count_packing(seqs)
        self._add_time("emit", t0)
        return ok

    def process_seqs(self, seqs: List[BSeq], n_processed: int = 0,
                     pes0=None, rg_id: str = "") -> None:
        """Align a chunk and write each read's SAM text to ``s.sam``."""
        from mpibwa_tpu_torch.core.cigar import set_cigar_cache
        from mpibwa_tpu_torch.core.pair import (mem_pestat, mem_sam_pe,
                                                set_sw_cache)

        if self._process_seqs_native(seqs, n_processed, pes0, rg_id):
            return
        fin = self._native_finalizer()
        cigar_cache = {} if fin is None else None
        regs_all = self.align_regs(seqs, cigar_cache)
        t0 = time.time()
        opt, refs = self.opt, self.refs
        n = len(seqs)
        try:
            set_cigar_cache(cigar_cache)
            if opt.flag & O.MEM_F_PE:
                pes = pes0 if pes0 is not None else mem_pestat(
                    opt, refs.l_pac, regs_all)
                if not self._finalize_in_c(fin, seqs, regs_all, True,
                                           n_processed >> 1, rg_id, pes):
                    t1 = time.time()
                    sw_cache = precompute_rescue(opt, refs, self.dfm, seqs,
                                                 regs_all, pes)
                    self.stats["rescue_problems"] += len(sw_cache)
                    self._add_time("rescue", t1)
                    t0 += time.time() - t1  # emit leaves the rescue out
                    set_sw_cache(sw_cache)
                    for i in range(n >> 1):
                        mem_sam_pe(opt, refs, pes, (n_processed >> 1) + i,
                                   seqs[i << 1: (i << 1) + 2],
                                   regs_all[i << 1: (i << 1) + 2], rg_id)
            elif not self._finalize_in_c(fin, seqs, regs_all, False,
                                         n_processed, rg_id):
                for i, s in enumerate(seqs):
                    regs = regs_all[i]
                    mem_mark_primary_se(opt, regs, n_processed + i)
                    if opt.flag & O.MEM_F_PRIMARY5:
                        mem_reorder_primary5(opt.T, regs)
                    s.sam = mem_reg2sam(opt, refs, s, regs, 0, None, rg_id)
        finally:
            set_cigar_cache(None)
            set_sw_cache(None)
        self._add_time("emit", t0)


def prep_global_problem(opt, refs, query_full, ar):
    """The inputs of mem_reg2aln's first gen_cigar call (bwa.c:120-170):
    (qseq, rseq, w, rev) after the reversal, or None where the scalar
    path's shortcut or reject branches apply."""
    from mpibwa_tpu_torch.core.sam import infer_bw

    qb, qe, rb, re = ar.qb, ar.qe, ar.rb, ar.re
    if ar.rb < 0 or ar.re < 0:
        return None
    tmp = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del)
    w2 = max(infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins,
                      opt.e_ins), tmp)
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    w2 = min(w2, opt.w << 2)
    l_query = qe - qb
    l_pac = refs.l_pac
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return None
    rseq = refs.get_seq(rb, re)
    rlen = len(rseq)
    if re - rb != rlen:
        return None
    query = np.ascontiguousarray(query_full[qb:qe])
    if rb >= l_pac:
        query = query[::-1].copy()
        rseq = rseq[::-1].copy()
    if l_query == rlen and w2 == 0:
        return None  # the no-DP shortcut; the scalar path is trivial
    max_ins = int((((l_query + 1) >> 1) * int(opt.mat[0]) - opt.o_ins)
                  / opt.e_ins + 1.0)
    max_del = int((((l_query + 1) >> 1) * int(opt.mat[0]) - opt.o_del)
                  / opt.e_del + 1.0)
    max_gap = max(max_ins, max_del, 1)
    w = (max_gap + abs(rlen - l_query) + 1) >> 1
    w = min(w, w2)
    w = max(w, abs(rlen - l_query) + 3)
    return query, rseq, w, rb >= l_pac


CIGAR_Q_BUCKETS = (64, 128, 192, 256, 512)
CIGAR_T_BUCKETS = (64, 128, 192, 256, 512, 768)


def precompute_cigars(opt, refs, qs_per_read, regs_per_read, dfm, qd,
                      mat55d):
    """The first-round global alignment of every region, batched on the
    device by (Q, T) bucket over the read batch qd (the microbatch's own
    device rows); returns the cigar cache of core.cigar.gen_cigar,
    {(query, rseq, w): (score, cigar)}. Problems beyond the largest bucket
    are left out: gen_cigar runs the scalar kernel for them."""
    from mpibwa_tpu_torch.ops.global_batch import (cigar_from_ops,
                                                   global_from_coords,
                                                   traceback_batch)

    uniq = {}  # identical problems run once
    for b, (query_full, regs) in enumerate(zip(qs_per_read, regs_per_read)):
        for ar in regs:
            prep = prep_global_problem(opt, refs, query_full, ar)
            if prep is None:
                continue
            q, t, w, rev = prep
            coords = ((b, ar.qb, ar.qe - ar.qb, 1, ar.re, ar.re - ar.rb)
                      if rev else
                      (b, ar.qb, ar.qe - ar.qb, 0, ar.rb, ar.re - ar.rb))
            uniq.setdefault((q.tobytes(), t.tobytes(), w), (q, t, coords))
    groups = {}
    for key, (q, t, coords) in uniq.items():
        if len(q) > CIGAR_Q_BUCKETS[-1] or len(t) > CIGAR_T_BUCKETS[-1]:
            continue
        QT = (_round_up(len(q), CIGAR_Q_BUCKETS),
              _round_up(len(t), CIGAR_T_BUCKETS))
        groups.setdefault(QT, []).append((key, coords))
    cache = {}
    dev = qd.device
    for (Q, T), items in groups.items():
        B = len(items)
        Bp = 1 << max(4, (B - 1).bit_length())
        cds = np.zeros((Bp, 6), np.int64)  # int64 r_start (doubled coords)
        cds[:, 2] = 1  # dummy qlen
        ws = np.full(Bp, 3, np.int32)
        for i, (key, coords) in enumerate(items):
            cds[i] = coords
            ws[i] = key[2]
        ws_d = torch.from_numpy(ws).to(dev)
        out = global_from_coords(dfm, qd, torch.from_numpy(cds).to(dev), Q,
                                 T, ws_d, opt.o_del, opt.e_del, opt.o_ins,
                                 opt.e_ins, mat55d)
        # the traceback on the device: (B, T+Q) op rows cross, not z
        ops, i_rem, k_rem = traceback_batch(
            out.z, torch.from_numpy(cds[:, 2]).to(dev),
            torch.from_numpy(cds[:, 5]).to(dev), ws_d)
        small = torch.stack([out.score.long(), i_rem.long(),
                             k_rem.long()]).cpu().numpy()  # one pull
        ops_np = ops.cpu().numpy()
        for i, (key, _) in enumerate(items):
            cache[key] = (int(small[0, i]), cigar_from_ops(
                ops_np[i], int(small[1, i]), int(small[2, i])))
    return cache


def precompute_rescue(opt, refs, dfm, seqs, regs_all, pes):
    """Every mate-rescue SW problem of a PE chunk, batched on the device.

    Enumerates exactly the ksw_align2 calls mem_sam_pe can make
    (bwamem_pair.c:265-275: the candidate regions times the four
    orientations whose insert stats did not fail); core.pair serves them
    from the returned cache {(seq, ref, xtra): KswR-shaped tuple}, and a
    miss (i16 mode, clamped-window edge cases) runs the scalar kernel."""
    from mpibwa_tpu_torch.core.extend import KSW_XBYTE, KSW_XSTART, KSW_XSUBO
    from mpibwa_tpu_torch.ops.rescue import ksw_align2_batch

    l_pac = refs.l_pac
    xtra = KSW_XSUBO | KSW_XSTART | KSW_XBYTE | (opt.min_seed_len * opt.a)
    seen = set()
    jobs = []  # (key, qcoords, tcoords)
    maxq = maxt = 1
    for pi in range(len(seqs) >> 1):
        for end in (0, 1):
            a_list = regs_all[(pi << 1) | end]
            if not a_list:
                continue
            mate_row = (pi << 1) | (1 - end)
            ms = seqs[mate_row].seq
            l_ms = len(ms)
            if l_ms * opt.a >= 250:
                continue  # i16 mode: the scalar kernel
            thr = a_list[0].score - opt.pen_unpaired
            nb = 0
            for reg in a_list:
                if reg.score < thr:
                    continue
                if nb >= opt.max_matesw:
                    break
                nb += 1
                for r in range(4):
                    if pes[r].failed:
                        continue
                    is_rev = (r >> 1) != (r & 1)
                    is_larger = not (r >> 1)
                    if not is_rev:
                        rb = (reg.rb + pes[r].low if is_larger
                              else reg.rb - pes[r].high)
                        re = (reg.rb + pes[r].high if is_larger
                              else reg.rb - pes[r].low) + l_ms
                    else:
                        rb = (reg.rb + pes[r].low if is_larger
                              else reg.rb - pes[r].high) - l_ms
                        re = (reg.rb + pes[r].high if is_larger
                              else reg.rb - pes[r].low)
                    rb = max(rb, 0)
                    re = min(re, l_pac << 1)
                    if rb >= re:
                        continue
                    ref, rid, rb2, re2 = refs.fetch_seq(rb, (rb + re) >> 1, re)
                    if not (reg.rid == rid and re2 - rb2 >= opt.min_seed_len):
                        continue
                    if is_rev:
                        seq = np.where(ms < 4, 3 - ms, 4)[::-1].astype(
                            np.uint8)
                        qc = (mate_row, l_ms - 1, -1, 1, l_ms)
                    else:
                        seq = ms
                        qc = (mate_row, 0, 1, 0, l_ms)
                    key = (seq.tobytes(), ref.tobytes(), xtra)
                    if key in seen:
                        continue
                    seen.add(key)
                    jobs.append((key, qc, (rb2, 1, re2 - rb2)))
                    maxq = max(maxq, l_ms)
                    maxt = max(maxt, re2 - rb2)
    if not jobs:
        return {}
    N = ((maxq + 15) >> 4) << 4
    Tcap = 256
    while Tcap < maxt:
        Tcap <<= 1
    qd = torch.from_numpy(_pad_batch(seq_source(seqs))[0]).to(dfm.device)
    res = ksw_align2_batch(dfm, qd, [{"qcoords": qc, "tcoords": tc}
                                     for _, qc, tc in jobs], opt, N, Tcap)
    return {key: r for (key, _, _), r in zip(jobs, res)}
