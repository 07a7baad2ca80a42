"""ctypes marshaling for the native finalization runtime (native/finalize.c).

The C library implements the exact post-region finalization — dedup/primary
marking, mapQ, PE pairing + mate rescue SW, CIGAR/MD/NM and SAM text
(semantics of bwamem.c:437-558/792-1049, bwamem_pair.c:111-393, bwa.c:120-208,
ksw.c:111-365/504-606, as specified by this repo's exact Python modules
core/{region,sam,pair,cigar,extend}.py) — over flat arrays, releasing the
GIL for the whole batch so pipelined aligner workers overlap host
finalization with device compute on real cores.

Any failure (missing compiler, OOM inside the library) degrades to the
Python path: finalize() returns False and the caller runs the exact Python
finalization instead, so bit-exactness never depends on this module.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

from mpibwa_tpu_torch.io.columns import columns_of

# Core-share bookkeeping for intra-batch parallel C phases: each entering
# batch takes a slot and receives its fair share of cores, so a single
# whole-file chunk (the reference's default -K covers the bundled example
# in one chunk) fans out across all cores while concurrent pipelined
# workers automatically split them instead of oversubscribing.
_CPU = os.cpu_count() or 1
_active = [0]
_active_lock = threading.Lock()
_MIN_SPLIT = 2048  # reads per extra thread before splitting pays


@contextlib.contextmanager
def _core_share():
    with _active_lock:
        _active[0] += 1
        share = max(1, _CPU // _active[0])
    try:
        yield share
    finally:
        with _active_lock:
            _active[0] -= 1


def _cuts(n: int, T: int, pair_align: bool):
    c = [round(i * n / T) for i in range(T + 1)]
    if pair_align:
        c = [x & ~1 for x in c[:-1]] + [n]
    return c

REG_DTYPE = np.dtype([
    ("rb", "<i8"), ("re", "<i8"),
    ("qb", "<i4"), ("qe", "<i4"), ("rid", "<i4"), ("score", "<i4"),
    ("truesc", "<i4"), ("sub", "<i4"), ("alt_sc", "<i4"), ("csub", "<i4"),
    ("sub_n", "<i4"), ("w", "<i4"), ("seedcov", "<i4"), ("secondary", "<i4"),
    ("secondary_all", "<i4"), ("seedlen0", "<i4"), ("n_comp", "<i4"),
    ("is_alt", "<i4"), ("hash", "<u8"), ("frac_rep", "<f8")])
assert REG_DTYPE.itemsize == 96  # must match alnreg_t in finalize.c

OPT_INT_FIELDS = ("a", "b", "o_del", "e_del", "o_ins", "e_ins", "pen_clip5",
                  "pen_clip3", "pen_unpaired", "w", "zdrop", "T", "flag",
                  "min_seed_len", "max_matesw", "max_XA_hits",
                  "max_XA_hits_alt", "max_chain_gap", "mapQ_coef_fac",
                  "min_chain_weight", "max_chain_extend", "max_occ")
OPT_FLT_FIELDS = ("mask_level", "drop_ratio", "XA_drop_ratio",
                  "mask_level_redun", "mapQ_coef_len")

_U64 = (1 << 64) - 1


def _vp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeFinalizer:
    """One per aligner; rebuilds its C context if opt fields change."""

    def __init__(self, refs, opt):
        self.refs = refs
        self.opt = opt
        self.lib = None
        self.ctx = None
        self._snap = None
        self._keep: list = []
        if os.environ.get("MPIBWA_FINAL", "native") != "native":
            return
        from mpibwa_tpu_torch import native

        self.lib = native.get_lib()

    @property
    def available(self) -> bool:
        return self.lib is not None

    def _opt_snapshot(self):
        o = self.opt
        return (tuple(getattr(o, f) for f in OPT_INT_FIELDS)
                + tuple(getattr(o, f) for f in OPT_FLT_FIELDS)
                + (o.mat.tobytes(),))

    def _ensure_ctx(self) -> bool:
        if self.lib is None:
            return False
        snap = self._opt_snapshot()
        if self.ctx is not None and snap == self._snap:
            return True
        if self.ctx is not None:
            self.lib.fin_ctx_free(self.ctx)
            self.ctx = None
        refs, o = self.refs, self.opt
        keep = []
        ref = np.ascontiguousarray(refs.ref, dtype=np.uint8)
        n = len(refs.anns)
        ann_off = np.array([a.offset for a in refs.anns], np.int64)
        ann_len = np.array([a.length for a in refs.anns], np.int64)
        ann_alt = np.array([a.is_alt for a in refs.anns], np.uint8)
        name_parts, name_off = [], np.zeros(n, np.int64)
        anno_parts, anno_off = [], np.zeros(n, np.int64)
        np_pos = an_pos = 0
        for i, a in enumerate(refs.anns):
            b = a.name.encode() + b"\0"
            name_off[i] = np_pos
            name_parts.append(b)
            np_pos += len(b)
            b = (a.anno or "").encode() + b"\0"
            anno_off[i] = an_pos
            anno_parts.append(b)
            an_pos += len(b)
        names = np.frombuffer(b"".join(name_parts), np.uint8)
        annos = np.frombuffer(b"".join(anno_parts), np.uint8)
        oi = np.array([getattr(o, f) for f in OPT_INT_FIELDS], np.int32)
        of = np.array([getattr(o, f) for f in OPT_FLT_FIELDS], np.float64)
        mat = np.ascontiguousarray(o.mat, dtype=np.int8)
        keep += [ref, ann_off, ann_len, ann_alt, names, anno_off, name_off,
                 annos, oi, of, mat]
        ctx = self.lib.fin_ctx_new(
            _vp(ref), ctypes.c_int64(refs.l_pac), ctypes.c_int32(n),
            _vp(ann_off), _vp(ann_len), _vp(ann_alt), _vp(names),
            _vp(name_off), _vp(annos), _vp(anno_off), _vp(oi), _vp(of),
            _vp(mat))
        if not ctx:
            return False
        self.ctx = ctx
        self._snap = snap
        self._keep = keep
        return True

    def __del__(self):
        try:
            if self.ctx is not None and self.lib is not None:
                self.lib.fin_ctx_free(self.ctx)
        except Exception:
            pass

    # -- batch packing -------------------------------------------------------

    @staticmethod
    def _pack_blobs(seqs):
        """The reads' fields as blobs and offsets: the batch's own columns
        when it has them (io/columns.py), else joined read by read."""
        cols = columns_of(seqs)
        if cols is not None:
            return cols.blobs()
        n = len(seqs)
        seq_off = np.zeros(n + 1, np.int64)
        qual_off = np.zeros(n + 1, np.int64)
        name_off = np.zeros(n + 1, np.int64)
        com_off = np.zeros(n + 1, np.int64)
        quals, names, coms = [], [], []
        t = 0
        for i, s in enumerate(seqs):
            t += len(s.seq)
            seq_off[i + 1] = t
            q = s.qual or ""
            quals.append(q)
            qual_off[i + 1] = qual_off[i] + len(q)
            names.append(s.name)
            name_off[i + 1] = name_off[i] + len(s.name.encode())
            c = s.comment or ""
            coms.append(c)
            com_off[i + 1] = com_off[i] + len(c.encode())
        seq_blob = (np.concatenate([s.seq for s in seqs])
                    if n else np.zeros(0, np.uint8))
        seq_blob = np.ascontiguousarray(seq_blob, dtype=np.uint8)
        qual_blob = np.frombuffer(("".join(quals)).encode() + b"\0", np.uint8)
        name_blob = np.frombuffer(("".join(names)).encode() + b"\0", np.uint8)
        com_blob = np.frombuffer(("".join(coms)).encode() + b"\0", np.uint8)
        return (seq_blob, seq_off, qual_blob, qual_off, name_blob, name_off,
                com_blob, com_off)

    @staticmethod
    def _pack_regs(regs_all):
        off = np.zeros(len(regs_all) + 1, np.int64)
        t = 0
        for i, regs in enumerate(regs_all):
            t += len(regs)
            off[i + 1] = t
        rows = [(r.rb, r.re, r.qb, r.qe, r.rid, r.score, r.truesc, r.sub,
                 r.alt_sc, r.csub, r.sub_n, r.w, r.seedcov, r.secondary,
                 r.secondary_all, r.seedlen0, r.n_comp, r.is_alt,
                 r.hash & _U64, r.frac_rep)
                for regs in regs_all for r in regs]
        arr = np.array(rows, dtype=REG_DTYPE) if rows else np.zeros(0, REG_DTYPE)
        return arr, off

    def finalize(self, seqs, regs_all, pe: bool, n_processed: int,
                 rg_id: str, pes=None) -> bool:
        """Writes s.sam for every read; False -> caller uses the Python path.

        For PE, n_processed must already be the pair-id base (n_processed>>1
        of the read counter) and pes the 4 mem_pestat entries."""
        if not self._ensure_ctx():
            return False
        n = len(seqs)
        (seq_blob, seq_off, qual_blob, qual_off, name_blob, name_off,
         com_blob, com_off) = self._pack_blobs(seqs)
        regs, reg_off = self._pack_regs(regs_all)
        if pe:
            pes_i = np.array([[p.low, p.high, p.failed] for p in pes],
                             np.int32).ravel()
            pes_f = np.array([[p.avg, p.std] for p in pes],
                             np.float64).ravel()
        else:
            pes_i = np.zeros(12, np.int32)
            pes_f = np.ones(8, np.float64)
        out_blob = ctypes.c_void_p()
        out_off = np.zeros(n + 1, np.int64)
        rc = self.lib.fin_batch(
            self.ctx, ctypes.c_int(1 if pe else 0), ctypes.c_int64(n),
            _vp(seq_blob), _vp(seq_off), _vp(qual_blob), _vp(qual_off),
            _vp(name_blob), _vp(name_off), _vp(com_blob), _vp(com_off),
            _vp(regs), _vp(reg_off), ctypes.c_int64(n_processed),
            rg_id.encode() if rg_id else b"", _vp(pes_i), _vp(pes_f),
            ctypes.byref(out_blob), _vp(out_off))
        if rc != 0:
            return False
        try:
            blob = ctypes.string_at(out_blob, int(out_off[n]))
        finally:
            self.lib.fin_buf_free(out_blob)
        for i, s in enumerate(seqs):
            s.sam = blob[out_off[i]:out_off[i + 1]].decode()
        return True


class NativeChainer:
    """Python side of the C chaining session (finalize.c chain stage): chains,
    chain filtering and region building run in C; the two extension rounds
    (left, right) run on the device between the calls. Shares the C context
    with NativeFinalizer."""

    def __init__(self, fin: NativeFinalizer):
        self.fin = fin

    @property
    def available(self) -> bool:
        return (self.fin.available
                and os.environ.get("MPIBWA_CHAIN", "native") == "native")

    def _copy_arr(self, ptr, n, cols, dtype):
        dt = np.dtype(dtype)
        if n == 0 or not ptr:
            return np.zeros((0, cols), dt)
        buf = ctypes.string_at(ptr, int(n) * cols * dt.itemsize)
        return np.frombuffer(buf, dt).reshape(int(n), cols).copy()

    def run(self, seqs, mems, resolve_sa, ext_rows, max_subset):
        """mems: flat (M,4) int64 rows in pass order (UNSORTED; C applies
        the exact ksort) + offsets; resolve_sa(ks int64[n]) -> positions
        int64[n] runs the device SA walk; ext_rows(coords, params) ->
        ((B,12) int32 rows, (B,) uint8 has-bits) runs the device extension
        rounds. Returns (regs structured array, reg_off int64[n+1]) or
        None.

        Reads are independent through the whole chain phase (per-read
        kbtree + per-read regions; the SA/extension device fan-outs are
        order-insensitive), so large batches split into contiguous read
        ranges chained by concurrent C sessions — the library releases
        the GIL and keeps only per-session state (g_oom is
        _Thread_local). Range results concatenate to the byte-identical
        single-session output."""
        import concurrent.futures

        n = len(seqs)
        mems_flat, mem_off = mems
        if not self.fin._ensure_ctx():  # once, before any range threads
            return None
        with _core_share() as share:
            T = max(1, min(share, n // _MIN_SPLIT))
            if T <= 1:
                return self._run_range(seqs, mems_flat, mem_off,
                                       resolve_sa, ext_rows, max_subset)
            cuts = _cuts(n, T, False)

            def piece(k):
                lo, hi = cuts[k], cuts[k + 1]
                mf = mems_flat[mem_off[lo] : mem_off[hi]]
                mo = mem_off[lo : hi + 1] - mem_off[lo]
                return self._run_range(seqs[lo:hi], mf, mo, resolve_sa,
                                       ext_rows, max_subset)

            with concurrent.futures.ThreadPoolExecutor(T) as ex:
                outs = list(ex.map(piece, range(T)))
        if any(o is None for o in outs):
            return None
        regs = np.concatenate([o[0] for o in outs])
        offs = [outs[0][1]]
        base = outs[0][1][-1]
        for o in outs[1:]:
            offs.append(o[1][1:] + base)
            base += o[1][-1]
        return regs, np.concatenate(offs)

    def _run_range(self, seqs, mems_flat, mem_off, resolve_sa, ext_rows,
                   max_subset):
        if not self.fin._ensure_ctx():
            return None
        lib = self.fin.lib
        mems_flat = np.ascontiguousarray(mems_flat, dtype=np.int64)
        n = len(seqs)
        blobs = self.fin._pack_blobs(seqs)
        seq_blob, seq_off = blobs[0], blobs[1]
        n_ks = np.zeros(1, np.int64)
        ks_p = ctypes.c_void_p()
        coords_p = ctypes.c_void_p()
        params_p = ctypes.c_void_p()
        sess = lib.fin_chain_begin(
            self.fin.ctx, ctypes.c_int64(n), _vp(seq_blob), _vp(seq_off),
            _vp(mems_flat), _vp(mem_off), ctypes.c_int(max_subset),
            _vp(n_ks), ctypes.byref(ks_p))
        if not sess:
            return None
        try:
            if n_ks[0] < 0:
                return None
            ks = self._copy_arr(ks_p.value, n_ks[0], 1, np.int64).ravel()
            sa_vals = np.ascontiguousarray(resolve_sa(ks), dtype=np.int64)
            n_left = np.zeros(1, np.int64)
            rc = lib.fin_chain_sa(sess, _vp(sa_vals), _vp(n_left),
                                  ctypes.byref(coords_p),
                                  ctypes.byref(params_p))
            if rc != 0:
                return None
            coords = self._copy_arr(coords_p.value, n_left[0], 6, np.int64)
            params = self._copy_arr(params_p.value, n_left[0], 4, np.int32)
            left_r, left_has = ext_rows(coords, params)
            n_right = np.zeros(1, np.int64)
            rc = lib.fin_chain_rights(sess, _vp(left_r), _vp(left_has),
                                      _vp(n_right), ctypes.byref(coords_p),
                                      ctypes.byref(params_p))
            if rc != 0:
                return None
            coords = self._copy_arr(coords_p.value, n_right[0], 6,
                                    np.int64)
            params = self._copy_arr(params_p.value, n_right[0], 4, np.int32)
            right_r, right_has = ext_rows(coords, params)
            regs_p = ctypes.c_void_p()
            reg_off = np.zeros(n + 1, np.int64)
            rc = lib.fin_chain_finish(sess, _vp(right_r), _vp(right_has),
                                      ctypes.byref(regs_p), _vp(reg_off))
            if rc != 0:
                return None
            n_regs = int(reg_off[n])
            if n_regs:
                buf = ctypes.string_at(regs_p.value,
                                       n_regs * REG_DTYPE.itemsize)
                regs = np.frombuffer(buf, REG_DTYPE).copy()
            else:
                regs = np.zeros(0, REG_DTYPE)
            lib.fin_buf_free(regs_p)
            return regs, reg_off
        finally:
            lib.fin_chain_end(sess)

    def pestat_isizes(self, regs, reg_off, max_ins):
        """C insert-size collection (cal_sub + direction windows); returns
        the four per-orientation isize lists, or None."""
        if not self.fin._ensure_ctx():
            return None
        lib = self.fin.lib
        n = len(reg_off) - 1
        cnt = np.zeros(4, np.int64)
        pes_i = np.zeros(12, np.int32)
        pes_f = np.zeros(8, np.float64)
        buf_p = ctypes.c_void_p()
        lib.fin_pestat(self.fin.ctx, _vp(regs), _vp(reg_off),
                       ctypes.c_int64(n), ctypes.c_int(max_ins), _vp(pes_i),
                       _vp(pes_f), _vp(cnt), ctypes.byref(buf_p))
        if not buf_p:
            return None
        cap = max(n, 1)
        raw = np.frombuffer(ctypes.string_at(buf_p.value, cap * 4 * 8),
                            np.int64).reshape(4, cap)
        out = [raw[d, : cnt[d]].tolist() for d in range(4)]
        lib.fin_buf_free(buf_p)
        return out

    def finalize_packed(self, seqs, regs, reg_off, pe, n_processed, rg_id,
                        pes=None) -> bool:
        """fin_batch over already-packed regions (the native-chain output).

        Finalization is per-read (SE) / per-pair (PE) independent given
        the batch-global pes stats, and the deterministic tie-break
        hashes key on n_processed + index — so large batches split into
        contiguous (pair-aligned) ranges finalized by concurrent C calls
        with rebased id bases, byte-identical to the single call."""
        import concurrent.futures

        n = len(seqs)
        if not self.fin._ensure_ctx():  # once, before any range threads
            return False
        with _core_share() as share:
            T = max(1, min(share, n // _MIN_SPLIT))
            if T <= 1:
                return self._finalize_packed_range(
                    seqs, regs, reg_off, pe, n_processed, rg_id, pes)
            cuts = _cuts(n, T, pe)

            def piece(k):
                lo, hi = cuts[k], cuts[k + 1]
                if lo >= hi:
                    return True
                r = np.ascontiguousarray(regs[reg_off[lo] : reg_off[hi]])
                ro = reg_off[lo : hi + 1] - reg_off[lo]
                ok = self._finalize_packed_range(
                    seqs[lo:hi], r, ro, pe,
                    n_processed + ((lo >> 1) if pe else lo), rg_id, pes)
                return ok

            with concurrent.futures.ThreadPoolExecutor(T) as ex:
                return all(ex.map(piece, range(T)))

    def _finalize_packed_range(self, seqs, regs, reg_off, pe, n_processed,
                               rg_id, pes=None) -> bool:
        fin = self.fin
        if not fin._ensure_ctx():
            return False
        n = len(seqs)
        (seq_blob, seq_off, qual_blob, qual_off, name_blob, name_off,
         com_blob, com_off) = fin._pack_blobs(seqs)
        if pe:
            pes_i = np.array([[p.low, p.high, p.failed] for p in pes],
                             np.int32).ravel()
            pes_f = np.array([[p.avg, p.std] for p in pes],
                             np.float64).ravel()
        else:
            pes_i = np.zeros(12, np.int32)
            pes_f = np.ones(8, np.float64)
        regs = np.ascontiguousarray(regs)
        out_blob = ctypes.c_void_p()
        out_off = np.zeros(n + 1, np.int64)
        rc = fin.lib.fin_batch(
            fin.ctx, ctypes.c_int(1 if pe else 0), ctypes.c_int64(n),
            _vp(seq_blob), _vp(seq_off), _vp(qual_blob), _vp(qual_off),
            _vp(name_blob), _vp(name_off), _vp(com_blob), _vp(com_off),
            _vp(regs), _vp(reg_off), ctypes.c_int64(n_processed),
            rg_id.encode() if rg_id else b"", _vp(pes_i), _vp(pes_f),
            ctypes.byref(out_blob), _vp(out_off))
        if rc != 0:
            return False
        try:
            blob = ctypes.string_at(out_blob, int(out_off[n]))
        finally:
            fin.lib.fin_buf_free(out_blob)
        for i, s in enumerate(seqs):
            s.sam = blob[out_off[i]:out_off[i + 1]].decode()
        return True


def regs_to_array(regs_lists):
    """AlnReg lists -> (packed REG_DTYPE array, int64 offsets)."""
    return NativeFinalizer._pack_regs(regs_lists)


def array_to_regs(regs, reg_off):
    """Packed regions -> per-read AlnReg lists (compat shim for callers of
    the public align_regs API)."""
    from mpibwa_tpu_torch.core.region import AlnReg

    out = []
    names = [n for n in REG_DTYPE.names]
    for b in range(len(reg_off) - 1):
        lst = []
        for i in range(int(reg_off[b]), int(reg_off[b + 1])):
            row = regs[i]
            r = AlnReg()
            for nm in names:
                setattr(r, nm, (float(row[nm]) if nm == "frac_rep"
                                else int(row[nm])))
            lst.append(r)
        out.append(lst)
    return out
