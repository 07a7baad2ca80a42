"""Device-resident FM-index and batched rank/extension primitives, PyTorch.

Counterpart of mpibwa_tpu/ops/fmd.py. The FM layout that is always on the
device is the O2 table (ops/backward8.build_o2): one (2,) int32 row [occ_c,
packed_word] per 16-base sub-block and base. Beside it live the L2
totals, the sampled SA and the packed forward reference. The classic
128-bp blocks (4 cumulative counts + 8 words of 16 packed bases) stay on
the host and are uploaded as one fused (n_blocks, 12) int32 table only when
an engine asks for them (fused_blocks(): MPIBWA_PALLAS=1, the pass kernel).

Positions are int32 when the doubled genome fits (seq_len + 2 < 2**31)
and int64 otherwise, or with ``force_wide``; counts and gather indices
into the O2 table fit int32 either way. Gathers clamp their indices into
range, as JAX's do, so lanes that carry stale or padding values read a
real row and are masked afterwards.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mpibwa_tpu_torch.ops.backward8 import (M0F, M33, M55, U32, _count_prefix,
                                            _occ_c2, build_o2)

# over-stepping the SA walk is exact (finished lanes no longer move), so
# the host checks for unfinished lanes once per this many steps
SA_STEPS_PER_SYNC = 8


class DeviceFMIndex:
    """Index tensors on one torch device + batched primitives."""

    def __init__(self, idx, device, force_wide: bool = False):
        """force_wide runs a small index through the int64 position path
        (build_o2 raises for a genome whose counts exceed int32)."""
        seq_len = int(idx.seq_len)
        wide = force_wide or not seq_len + 2 < 2**31
        np_idt = np.int64 if wide else np.int32
        sa = np.asarray(idx.sa).view(np.int64)
        n_blocks = len(idx.bwt) // 16
        blocks = np.ascontiguousarray(
            idx.bwt[: n_blocks * 16]).reshape(n_blocks, 16)
        occ = blocks[:, :8].copy().view(np.uint64)
        if occ.max() > np.iinfo(np.int32).max:
            raise ValueError("occ counts exceed int32; unsupported genome "
                             "size")
        state = {
            "_o2": build_o2(idx.bwt),
            "occ": occ.astype(np.int32),
            "data": np.ascontiguousarray(blocks[:, 8:]),
            "L2": np.asarray(idx.L2).astype(np_idt),
            "sa": sa.astype(np_idt),  # -1 sentinel preserved
            "pac": np.asarray(idx.pac),
            "primary": int(idx.primary),
            "seq_len": seq_len,
            "sa_intv": int(idx.sa_intv),
            "l_pac": int(idx.l_pac),
            "idt": np_idt,
        }
        self._load(state, device)

    @classmethod
    def from_numpy(cls, state: dict, device) -> "DeviceFMIndex":
        """Build from numpy arrays (``_o2``, ``L2``, ``sa``, ``pac``, and
        optionally the classic block tables ``occ`` (n_blocks, 4) int32 and
        ``data`` (n_blocks, 8) uint32) and scalars (``primary``,
        ``seq_len``, ``sa_intv``, ``l_pac``, ``idt`` = the position dtype),
        e.g. the arrays of a mpibwa_tpu DeviceFMIndex pulled to the host."""
        obj = cls.__new__(cls)
        obj._load(state, device)
        return obj

    def _load(self, state: dict, device):
        self.device = torch.device(device)
        self.np_idt = np.dtype(state["idt"]).type
        if self.np_idt not in (np.int32, np.int64):
            raise ValueError(f"position dtype must be int32 or int64, got "
                             f"{self.np_idt}")
        self.idt = torch.int32 if self.np_idt == np.int32 else torch.int64
        self.primary = int(state["primary"])
        self.seq_len = int(state["seq_len"])
        self.sa_intv = int(state["sa_intv"])
        self.l_pac = int(state["l_pac"])

        def put(a, dt):
            return torch.from_numpy(
                np.ascontiguousarray(np.asarray(a).astype(dt))).to(
                    self.device)

        self._o2 = put(state["_o2"], np.int32)
        self.L2 = put(state["L2"], self.np_idt)
        self.sa = put(state["sa"], self.np_idt)
        self.pac = put(state["pac"], np.uint8)
        # host copy of L2[0..3]: the CUDA wrappers pass them by value
        self.l2_host = [int(v) for v in np.asarray(state["L2"])[:4]]
        occ, data = state.get("occ"), state.get("data")
        self._host_occ = None if occ is None else np.asarray(occ, np.int32)
        self._host_data = None if data is None else np.asarray(data,
                                                               np.uint32)
        self._fused = None
        self._fused_args = None

    def o2_tables(self) -> torch.Tensor:
        return self._o2

    def fused_blocks(self) -> torch.Tensor:
        """(n_blocks, 12) int32 fused rows [occ[0..3], data[0..7]] of the
        classic 128-bp blocks: one 48-byte row serves both the cumulative
        counts and the packed words. int32 position path only. Uploaded on
        first use and cached (48 B per 128 bp of the doubled genome)."""
        if self._fused is None:
            if self.idt != torch.int32:
                raise ValueError("fused blocks need the int32 position path")
            if self._host_occ is None or self._host_data is None:
                raise ValueError("this index was loaded without the classic "
                                 "block tables (occ, data)")
            fused = np.concatenate(
                [self._host_occ, self._host_data.view(np.int32)], axis=1)
            self._fused = torch.from_numpy(
                np.ascontiguousarray(fused)).to(self.device)
        return self._fused

    def fused_args(self) -> "tuple[torch.device, tuple]":
        """(device, (pointer, n_blocks, L2[0], .., L2[3], primary)) of the
        fused table: the leading arguments of the block kernels' C entry
        points, worked out once."""
        if self._fused_args is None:
            t = self.fused_blocks()
            self._fused_args = (t.device, (t.data_ptr(), t.shape[0],
                                           *self.l2_host, self.primary))
        return self._fused_args

    # -- batched occ4 over the classic blocks --------------------------------

    def occ4(self, ks: torch.Tensor) -> torch.Tensor:
        """(...,) positions (negative = sentinel) -> (..., 4) idt: bwt_occ4
        (bwt.c:98-105, 165-186) as a scan of the position's 128-bp block.
        Per 16-base word the bases past the position are masked off (they
        then read as base 0, which the base-0 count takes back), and base c
        is counted with the __occ_aux bit trick. Bit-identical to occ4_16;
        the plain versions of the block-layout kernels rest on it."""
        rows = self.fused_blocks()
        sent = ks < 0
        k = torch.where(sent, torch.zeros_like(ks), ks)
        k = k - (k >= self.primary).to(k.dtype)
        blk = (k.to(torch.int64) >> 7).clamp(0, rows.shape[0] - 1)
        within = (k & 127).to(torch.int64)
        row = rows[blk].to(torch.int64)  # (..., 12)
        words = row[..., 4:] & U32
        widx = torch.arange(8, device=ks.device)
        nvalid = (within[..., None] + 1 - widx * 16).clamp(0, 16)  # (..., 8)
        # 64-bit lanes: the shift by 32 of nvalid == 0 gives mask 0
        mask = ~((torch.ones_like(nvalid) << (32 - 2 * nvalid)) - 1) & U32
        w = words & mask
        nw = ~w & U32
        cnts = []
        for c in range(4):
            a = (w if c & 2 else nw) >> 1
            b = w if c & 1 else nw
            m = a & b & M55
            x = (m & M33) + ((m >> 2) & M33)
            x = (x + (x >> 4)) & M0F
            cnts.append(((x + (x >> 8) + (x >> 16) + (x >> 24))
                         & 0x3F).sum(dim=-1))
        cnt = torch.stack(cnts, dim=-1)
        cnt[..., 0] -= (16 - nvalid).sum(dim=-1)
        out = (row[..., :4] + cnt).to(self.idt)
        return torch.where(sent[..., None], torch.zeros_like(out), out)

    # -- batched occ4 through O2 ---------------------------------------------

    def occ4_16(self, ks: torch.Tensor) -> torch.Tensor:
        """(...,) positions (negative = sentinel) -> (..., 4) idt: bwt_occ4
        through the O2 table, one 4-row gather per position."""
        o2 = self._o2
        sent = ks < 0
        k = torch.where(sent, torch.zeros_like(ks), ks)
        k = k - (k >= self.primary).to(k.dtype)
        sb = k.to(torch.int64) >> 4
        within = (k & 15).to(torch.int64)
        idx = ((sb[..., None] << 2)
               + torch.arange(4, device=ks.device)).clamp(0, o2.shape[0] - 1)
        rows = o2[idx]  # (..., 4, 2)
        base = rows[..., 0]
        keep = ~((torch.ones_like(within) << (30 - 2 * within)) - 1) & U32
        w = (rows[..., 0, 1].to(torch.int64) & U32) & keep
        nw = ~w & U32
        cnts = []
        for c in range(4):
            a = (w if c & 2 else nw) >> 1
            b = w if c & 1 else nw
            m = a & b & M55
            x = (m & M33) + ((m >> 2) & M33)
            x = (x + (x >> 4)) & M0F
            cnts.append(((x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F))
        cnt = torch.stack(cnts, dim=-1).to(torch.int32)
        cnt[..., 0] -= (15 - within).to(torch.int32)
        out = (base + cnt).to(self.idt)
        return torch.where(sent[..., None], torch.zeros_like(out), out)

    def occ4_cols16(self, ks: torch.Tensor) -> torch.Tensor:
        """(E,) positions -> (4, E) idt: occ4_16 in the column layout of
        the contig backward engine (ops/seeding_flat.py)."""
        return self.occ4_16(ks).t()

    def extend_back1(self, k, l, s, c):
        """Backward-extend the (E,) intervals (k, l, s) by the per-entry
        base c (0..3): the row c of extend(ik, 1) (bwt_extend,
        bwt.c:262-275) in column layout; garbage c of masked entries is
        harmless. Returns (k, l, s) of the extended intervals."""
        kq = k - 1
        tk = self.occ4_cols16(kq)  # (4, E)
        tl = self.occ4_cols16(kq + s)
        x2 = tl - tk
        add = ((k <= self.primary) & (k + s - 1 >= self.primary)).to(self.idt)
        l3 = l + add
        lb2 = l3 + x2[3]
        lb1 = lb2 + x2[2]
        lb0 = lb1 + x2[1]
        cc = c.long()[None]

        def pick(rows):
            return rows.gather(0, cc)[0]

        kc = self.L2[c.long()] + 1 + pick(tk)
        sc = pick(x2)
        lc = pick(torch.stack([lb0, lb1, lb2, l3]))
        return kc, lc, sc

    # -- batched bidirectional extension (bwt_extend, bwt.c:262-275) ---------

    def extend(self, ik: torch.Tensor, is_back: int) -> torch.Tensor:
        """ik: (..., 3) idt intervals -> (..., 4, 3) for the 4 bases.

        MPIBWA_PALLAS=1 serves a 2-D batch of int32 intervals, at any entry
        count, through the fused occ4 + bwt_extend kernel over the classic
        blocks (ops/occ4_cuda.extend_kernel: the CUDA kernel on a CUDA
        tensor, its plain version on a CPU tensor), with bit-identical
        output. An int64 index or a batch of another rank takes the O2 path
        below, which is mpibwa_tpu's own rule. Off by default."""
        if (os.environ.get("MPIBWA_PALLAS", "0") == "1"
                and self.idt == torch.int32 and ik.dim() == 2):
            from mpibwa_tpu_torch.ops.occ4_cuda import extend_kernel

            return extend_kernel(self, ik, is_back)
        return self.extend_with(ik, is_back, self.occ4_16)

    def extend_with(self, ik: torch.Tensor, is_back: int, occ4
                    ) -> torch.Tensor:
        """The arithmetic of bwt_extend over the ranks ``occ4`` gives at
        k - 1 and k - 1 + x2 (occ4: (..., 2) positions -> (..., 2, 4))."""
        col = 0 if is_back else 1  # x[!is_back]
        oth = 1 - col
        kq = ik[..., col] - 1
        both = occ4(torch.stack([kq, kq + ik[..., 2]], dim=-1))
        tk = both[..., 0, :]
        tl = both[..., 1, :]
        okx2 = tl - tk
        ok_main = self.L2[:4] + 1 + tk
        # the interval before extension spans the sentinel
        add = ((ik[..., col] <= self.primary)
               & (ik[..., col] + ik[..., 2] - 1 >= self.primary)).to(self.idt)
        ok3 = ik[..., oth] + add
        okb2 = ok3 + okx2[..., 3]
        okb1 = okb2 + okx2[..., 2]
        okb0 = okb1 + okx2[..., 1]
        ok_oth = torch.stack([okb0, okb1, okb2, ok3], dim=-1)
        parts = [None, None, None]
        parts[col] = ok_main
        parts[oth] = ok_oth
        parts[2] = okx2
        return torch.stack(parts, dim=-1)

    def extend1_fwd(self, ik0, ik1, ik2, cb):
        """Forward-extend intervals (ik0, ik1, ik2) by per-entry complement
        base cb; exactly row cb of extend(ik, 0), computed from one 4-wide
        O2 gather (see mpibwa_tpu/ops/fmd.py extend1_fwd for the identity
        sum_b occ_b(k) = k+1 it rests on)."""
        o2 = self._o2
        idt = self.idt
        kq = ik1 - 1
        lq = kq + ik2
        # extra base whose rank completes G_{cb+1}: occ_0 for cb==1, occ_3
        # for cb==2; cb==0/3 need none (a dummy is gathered and masked off)
        eb = torch.where(cb == 1, 0, 3).to(cb.dtype)
        W = kq.shape[-1]
        ks4 = torch.cat([kq, lq, kq, lq], dim=-1)
        c4 = torch.cat([cb, cb, eb, eb], dim=-1)
        sent = ks4 < 0
        k = torch.where(sent, torch.zeros_like(ks4), ks4)
        k = k - (k >= self.primary).to(k.dtype)
        sb = k.to(torch.int64) >> 4
        within = (k & 15).to(torch.int32)
        idx = ((sb << 2) + c4).clamp(0, o2.shape[0] - 1)
        row = o2[idx]  # (..., 4W, 2)
        occ4w = torch.where(sent, 0, row[..., 0]
                            + _count_prefix(row[..., 1], c4, within))
        # chars <= position in shifted coords (0 at the sentinel)
        tot4w = torch.where(sent, torch.zeros_like(k), k + 1).to(idt)
        tkc = occ4w[..., :W]
        tlc = occ4w[..., W: 2 * W]
        ek = occ4w[..., 2 * W: 3 * W].to(idt)
        el = occ4w[..., 3 * W:].to(idt)
        totk = tot4w[..., :W]
        totl = tot4w[..., W: 2 * W]
        zero = torch.zeros((), dtype=idt, device=kq.device)

        def g_term(tot, occ_c, occ_e):
            return torch.where(
                cb == 0, tot - occ_c,
                torch.where(cb == 1, tot - occ_e - occ_c,
                            torch.where(cb == 2, occ_e, zero)))

        gk = g_term(totk, tkc.to(idt), ek)
        gl = g_term(totl, tlc.to(idt), el)
        s2 = (tlc - tkc).to(idt)
        k1n = self.L2[cb.clamp(0, 3).long()] + 1 + tkc.to(idt)
        add = ((ik1 <= self.primary)
               & (ik1 + ik2 - 1 >= self.primary)).to(idt)
        k0n = ik0 + add + (gl - gk)
        return k0n, k1n, s2

    # -- batched set_intv ----------------------------------------------------

    def set_intv(self, c: torch.Tensor) -> torch.Tensor:
        """(N,) base codes (<4) -> (N, 3) initial single-base intervals."""
        c = c.long()
        x0 = self.L2[c] + 1
        x2 = self.L2[c + 1] - self.L2[c]
        x1 = self.L2[3 - c] + 1
        return torch.stack([x0, x1, x2], dim=-1)

    def ref_base(self, pos: torch.Tensor) -> torch.Tensor:
        """Reference base at doubled-coordinate pos (bns_get_seq semantics:
        positions >= l_pac are the reverse complement strand); pos is
        clipped into range, callers mask invalid lanes. int32."""
        is_rev = pos >= self.l_pac
        p = torch.where(is_rev, 2 * self.l_pac - 1 - pos, pos)
        p = p.clamp(0, self.l_pac - 1).to(torch.int64)
        byte = self.pac[p >> 2].to(torch.int32)
        shift = (((~p) & 3) << 1).to(torch.int32)
        b = (byte >> shift) & 3
        return torch.where(is_rev, 3 - b, b)

    # -- batched SA lookup (bwt_sa, bwt.c:86-96) -----------------------------

    def sa_lookup(self, ks: torch.Tensor) -> torch.Tensor:
        """(N,) SA indices -> (N,) idt positions, by the O2 walk."""
        return _sa_lookup16(self._o2, self.L2, self.primary, self.seq_len,
                            self.sa, self.sa_intv, ks.to(self.idt))


def _sa_lookup16(o2, l2, primary: int, seq_len: int, sa, sa_intv: int,
                 ks: torch.Tensor) -> torch.Tensor:
    """bwt_sa walk (bwt.c:86-96) via the O2 table: per step one row gather
    for the BWT base word and one single-base rank row gather (_occ_c2).
    Position arithmetic runs in the dtype of ks; counts stay int32."""
    idt = ks.dtype
    mask = sa_intv - 1  # sa_intv is a power of two
    n_rows = o2.shape[0]

    def bwt_b0_o2(x):
        idx = ((x.to(torch.int64) >> 4) << 2).clamp(0, n_rows - 1)
        word = o2[idx, 1].to(torch.int64) & U32
        sh = ((~x).to(torch.int64) & 15) << 1
        return ((word >> sh) & 3).to(torch.int32)

    def inv_psi(k):
        x = k - (k > primary).to(idt)
        c = bwt_b0_o2(x)
        occc = _occ_c2(o2, primary, k, c)
        cl = c.long()
        occc = torch.where(k == seq_len, (l2[cl + 1] - l2[cl]).to(torch.int32),
                           occc)
        val = l2[cl] + occc.to(idt)
        return torch.where(k == primary, torch.zeros_like(val), val)

    k = ks
    steps = torch.zeros_like(ks)
    act = (k & mask) != 0
    while bool(act.any()):
        for _ in range(SA_STEPS_PER_SYNC):
            k = torch.where(act, inv_psi(k), k)
            steps = steps + act.to(idt)
            act = (k & mask) != 0
    base = sa[(k // sa_intv).to(torch.int64).clamp(0, sa.shape[0] - 1)]
    return steps + base.to(idt)  # sa[0] == -1 wraps like the C uint64
