"""Batched SMEM forward automata (mem_collect_intv passes 1 and 3), PyTorch.

Counterpart of mpibwa_tpu/ops/seeding.py ``forward_pass`` and
``forward_p3``: lockstep automata with one interval-extension step per
round for a whole batch of reads. The chained sequence of bwt_smem1 calls
is decided by forward extension alone (bwt.c:304-321), which is what
makes the two-phase (forward, then backward) batching exact.

Per-read outputs land in flat buffers with one spare "dump" slot at the
end: lanes that must not write scatter there, and the slot is sliced off
(JAX's drop-mode scatter). Buffers overflow into per-read flags; flagged
reads take the scalar host engine.

These host loops are the plain versions of the CUDA kernels of
csrc/fwd_automata.cu (ops/fwd_cuda.py), which run each loop in one launch
on the card. The tests and the CPU route run them; nothing on the card's
main path calls them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F_CAP = 192  # max forward-pushed intervals per read (all calls)
C_CAP = 48  # max smem1 calls per read
S3_CAP = 24  # max pass-3 seeds per read
# device_seed packs a call's start and length into 8 bits each
assert F_CAP <= 255

# over-stepping is exact (DONE lanes no longer change), so the host checks
# for unfinished lanes once per this many rounds
ROUNDS_PER_SYNC = 4

SEEK, EXT, DONE = 0, 1, 2


class FwdOut(NamedTuple):
    ivals: torch.Tensor  # (B, F_CAP, 3) idt pushed intervals
    infos: torch.Tensor  # (B, F_CAP) int32 pushed info (end position)
    n_pushed: torch.Tensor  # (B,) int32
    call_x: torch.Tensor  # (B, C_CAP) int32 start of each call
    call_start: torch.Tensor  # (B, C_CAP) int32 index of first push
    call_len: torch.Tensor  # (B, C_CAP) int32 number of pushes
    n_calls: torch.Tensor  # (B,) int32
    overflow: torch.Tensor  # (B,) bool


class Pass3Out(NamedTuple):
    seeds: torch.Tensor  # (B, S3_CAP, 3) idt
    infos: torch.Tensor  # (B, S3_CAP) int64 (start << 32 | end)
    n_seeds: torch.Tensor  # (B,) int32
    overflow: torch.Tensor  # (B,) bool


def _put(buf: torch.Tensor, ok: torch.Tensor, slot: torch.Tensor,
         val: torch.Tensor) -> None:
    """buf[slot] = val where ok; other lanes write the dump slot buf[-1]."""
    buf[torch.where(ok, slot, buf.shape[0] - 1)] = val


class _Fwd:
    """State of the pass-1/pass-2 forward automaton for B lanes."""

    def __init__(self, fm, B, x0, dev):
        idt, i32 = fm.idt, torch.int32
        self.x = x0
        self.kind = torch.full((B,), SEEK, dtype=i32, device=dev)
        self.ik0 = torch.zeros(B, dtype=idt, device=dev)
        self.ik1 = torch.zeros(B, dtype=idt, device=dev)
        self.ik2 = torch.zeros(B, dtype=idt, device=dev)
        self.info = torch.zeros(B, dtype=i32, device=dev)
        self.i = torch.zeros(B, dtype=i32, device=dev)
        self.n_pushed = torch.zeros(B, dtype=i32, device=dev)
        self.n_calls = torch.zeros(B, dtype=i32, device=dev)
        self.overflow = torch.zeros(B, dtype=torch.bool, device=dev)
        F, C = B * F_CAP, B * C_CAP
        self.iv = torch.zeros((3, F + 1), dtype=idt, device=dev)
        self.infos = torch.zeros(F + 1, dtype=i32, device=dev)
        self.call_x = torch.zeros(C + 1, dtype=i32, device=dev)
        self.call_start = torch.zeros(C + 1, dtype=i32, device=dev)

    def seek(self, qx, lens, lane, chain: bool):
        """Seek step: start a call at x (or skip an ambiguous base). Returns
        the lanes that began a call."""
        seek = self.kind == SEEK
        x = self.x
        fin = seek & (x >= lens)
        amb = seek & ~fin & (qx > 3)
        beg = seek & ~fin & ~amb
        call_ov = beg & (self.n_calls >= C_CAP)
        beg = beg & ~call_ov
        if not chain:
            # single-call mode: an ambiguous start yields no mems (bwt.c:296)
            fin = fin | amb
            amb = torch.zeros_like(amb)
        self.overflow = self.overflow | call_ov
        self.kind = torch.where(fin | call_ov, DONE, self.kind)
        self.x = torch.where(amb, x + 1, x)
        cslot = lane * C_CAP + self.n_calls.clamp(max=C_CAP - 1)
        _put(self.call_x, beg, cslot, x)
        _put(self.call_start, beg, cslot, self.n_pushed)
        self.n_calls = self.n_calls + beg.to(torch.int32)
        return beg, x

    def begin(self, beg, x, ikn):
        self.ik0 = torch.where(beg, ikn[..., 0], self.ik0)
        self.ik1 = torch.where(beg, ikn[..., 1], self.ik1)
        self.ik2 = torch.where(beg, ikn[..., 2], self.ik2)
        self.info = torch.where(beg, x + 1, self.info)
        self.i = torch.where(beg, x + 1, self.i)
        self.kind = torch.where(beg, EXT, self.kind)

    def step(self, qi, lens, minv, nk, lane, chain: bool):
        """Extend step bookkeeping for lanes in EXT, given the next base qi
        and the forward extension nk = (k0, k1, s) of the current interval."""
        nk0, nk1, ns = nk
        ext = self.kind == EXT
        i = self.i
        at_end = ext & (i >= lens)
        amb_i = ext & ~at_end & (qi > 3)
        do_ext = ext & ~at_end & ~amb_i
        changed = ns != self.ik2
        too_small = ns < minv
        # pushes: end of read, ambiguous base, or a size change
        push_now = at_end | amb_i | (do_ext & changed)
        can = push_now & (self.n_pushed < F_CAP)
        slot = lane * F_CAP + self.n_pushed
        for r, v in enumerate((self.ik0, self.ik1, self.ik2)):
            _put(self.iv[r], can, slot, v)
        _put(self.infos, can, slot, self.info)
        self.overflow = self.overflow | (push_now & (self.n_pushed >= F_CAP))
        self.n_pushed = self.n_pushed + push_now.to(torch.int32)
        # call end: the last pushed info is the return (every terminating
        # lane pushed this round, so it is the lane's info register)
        term = at_end | amb_i | (do_ext & changed & too_small)
        if chain:
            self.x = torch.where(term, self.info, self.x)
            self.kind = torch.where(term, SEEK, self.kind)
        else:
            self.kind = torch.where(term, DONE, self.kind)
        go_on = do_ext & ~(changed & too_small)
        self.ik0 = torch.where(go_on, nk0, self.ik0)
        self.ik1 = torch.where(go_on, nk1, self.ik1)
        self.ik2 = torch.where(go_on, ns, self.ik2)
        self.info = torch.where(go_on, i + 1, self.info)
        self.i = torch.where(go_on, i + 1, self.i)

    def out(self, B) -> FwdOut:
        F, C = B * F_CAP, B * C_CAP
        call_start = self.call_start[:C].reshape(B, C_CAP)
        # call_len[c] = call_start[c+1] - call_start[c] (last: n_pushed -
        # start): pushes within a call are consecutive
        nc = self.n_calls.clamp(max=C_CAP)[:, None]
        cix = torch.arange(C_CAP, dtype=torch.int32,
                           device=call_start.device)[None, :]
        nxt = torch.cat([call_start[:, 1:], torch.zeros_like(call_start[:, :1])],
                        dim=1)
        nxt = torch.where(cix + 1 < nc, nxt, self.n_pushed[:, None])
        call_len = torch.where(cix < nc, nxt - call_start, 0)
        ivals = self.iv[:, :F].reshape(3, B, F_CAP).permute(1, 2, 0)
        return FwdOut(ivals.contiguous(), self.infos[:F].reshape(B, F_CAP),
                      self.n_pushed, self.call_x[:C].reshape(B, C_CAP),
                      call_start, call_len, self.n_calls, self.overflow)


class _Trace:
    """What a run of the automata needs, for a bound: the rounds in which a
    lane was not done (the longest lane's steps), the forward extensions
    the lanes needed and the distinct O2 sub-blocks (32-byte sectors) they
    read, at ik1 - 1 and ik1 - 1 + ik2 (ops/fmd.extend1_fwd); and the
    sector loads, one an extension where both positions share a sub-block,
    else two."""

    def __init__(self, fm, dev):
        self.primary = fm.primary
        self.rounds = torch.zeros((), dtype=torch.int64, device=dev)
        self.steps = torch.zeros((), dtype=torch.int64, device=dev)
        self.loads = torch.zeros((), dtype=torch.int64, device=dev)
        self.blocks = []

    def round(self, active: torch.Tensor) -> None:
        self.rounds += active.any().to(torch.int64)

    def extend(self, need: torch.Tensor, ik1: torch.Tensor,
               ik2: torch.Tensor) -> None:
        kq = ik1[need] - 1
        for pos in (kq, kq + ik2[need]):
            k = pos.clamp(min=0)
            self.blocks.append((k - (k >= self.primary).to(k.dtype)) >> 4)
        self.steps += need.sum()
        self.loads += need.sum() + (self.blocks[-1] != self.blocks[-2]).sum()

    def done(self, stats: dict) -> None:
        stats["rounds"] = int(self.rounds)
        stats["steps"] = int(self.steps)
        stats["loads"] = int(self.loads)
        stats["sectors"] = (int(torch.unique(torch.cat(self.blocks)).numel())
                            if self.blocks else 0)


def _query_at(qflat: torch.Tensor, L: int, lane: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """Base of read `lane` at pos, 4 outside the read buffer. int32."""
    got = qflat[lane * L + pos.clamp(0, L - 1)]
    return torch.where((pos >= 0) & (pos < L), got, 4)


def forward_pass(fm, q: torch.Tensor, lens: torch.Tensor,
                 min_intv: torch.Tensor, chain: bool = True,
                 starts: torch.Tensor = None, stats: dict = None) -> FwdOut:
    """Run chained (pass 1) or single (pass 2) smem1 forward loops.

    q: (B, L) uint8 nt4 codes (pad >= 4); lens: (B,) int32; min_intv: (B,)
    int64; starts: (B,) int32 initial x (default 0). chain=True: after each
    call, continue from the returned position; chain=False: exactly one
    call per lane.

    The plain version of ops/fwd_cuda.forward_pass_kernel: a host loop of
    small torch ops, every lane a step a round, with a host check every
    ROUNDS_PER_SYNC rounds. The tests and the CPU route run it. A stats
    dict, where given, receives the run's rounds, needed extensions and
    distinct O2 sectors (_Trace)."""
    B, L = q.shape
    dev = q.device
    lane = torch.arange(B, dtype=torch.int64, device=dev)
    qflat = q.reshape(-1).to(torch.int32)
    lens = lens.to(torch.int32)
    minv = min_intv.to(fm.idt)
    x0 = (torch.zeros(B, dtype=torch.int32, device=dev) if starts is None
          else starts.to(torch.int32))
    st = _Fwd(fm, B, x0, dev)
    trace = None if stats is None else _Trace(fm, dev)
    while bool((st.kind != DONE).any()):
        for _ in range(ROUNDS_PER_SYNC):
            if trace is not None:
                trace.round(st.kind != DONE)
            qx = _query_at(qflat, L, lane, st.x)
            beg, x = st.seek(qx, lens, lane, chain)
            st.begin(beg, x, fm.set_intv(qx.clamp(0, 3)))
            qi = _query_at(qflat, L, lane, st.i)
            if trace is not None:
                trace.extend((st.kind == EXT) & (st.i < lens) & (qi <= 3),
                             st.ik1, st.ik2)
            cb = 3 - qi.clamp(0, 3)
            nk = fm.extend1_fwd(st.ik0, st.ik1, st.ik2, cb)
            st.step(qi, lens, minv, nk, lane, chain)
    if trace is not None:
        trace.done(stats)
    return st.out(B)


def forward_p3(fm, q: torch.Tensor, lens: torch.Tensor,
               min_intv: torch.Tensor, min_seed_len: int, max_intv: int,
               stats: dict = None) -> "tuple[FwdOut, Pass3Out]":
    """The chained pass-1 forward loop and the pass-3 sweep
    (bwt_seed_strategy1, bwt.c:358-379) in one loop, sharing each round's
    query reads, set_intv and forward extension between the two automata.
    Exactly forward_pass(chain=True) + pass 3.

    The plain version of ops/fwd_cuda.forward_p3_kernel, a host loop like
    forward_pass's (stats too, over both automata). The tests and the CPU
    route run it."""
    B, L = q.shape
    dev = q.device
    idt, i32 = fm.idt, torch.int32
    lane = torch.arange(B, dtype=torch.int64, device=dev)
    qflat = q.reshape(-1).to(i32)
    lens = lens.to(i32)
    minv = min_intv.to(idt)
    st = _Fwd(fm, B, torch.zeros(B, dtype=i32, device=dev), dev)
    # pass-3 automaton
    px = torch.zeros(B, dtype=i32, device=dev)
    pi = torch.zeros(B, dtype=i32, device=dev)
    pkind = torch.full((B,), SEEK, dtype=i32, device=dev)
    pk = [torch.zeros(B, dtype=idt, device=dev) for _ in range(3)]
    pn = torch.zeros(B, dtype=i32, device=dev)
    pov = torch.zeros(B, dtype=torch.bool, device=dev)
    S3 = B * S3_CAP
    seeds = torch.zeros((3, S3 + 1), dtype=idt, device=dev)
    sx = torch.zeros(S3 + 1, dtype=i32, device=dev)
    si = torch.zeros(S3 + 1, dtype=i32, device=dev)

    trace = None if stats is None else _Trace(fm, dev)
    while bool(((st.kind != DONE) | (pkind != DONE)).any()):
        for _ in range(ROUNDS_PER_SYNC):
            if trace is not None:
                trace.round((st.kind != DONE) | (pkind != DONE))
            # seek bases for both automata (one gather)
            q2 = _query_at(qflat, L, torch.cat([lane, lane]),
                           torch.cat([st.x, px]))
            qx, pqx = q2[:B], q2[B:]
            beg, x = st.seek(qx, lens, lane, True)
            pseek = pkind == SEEK
            pfin = pseek & (px >= lens)
            pamb = pseek & ~pfin & (pqx > 3)
            pbeg = pseek & ~pfin & ~pamb
            pkind = torch.where(pfin, DONE, pkind)
            px = torch.where(pamb, px + 1, px)
            ikn = fm.set_intv(q2.clamp(0, 3))
            st.begin(beg, x, ikn[:B])
            pk = [torch.where(pbeg, ikn[B:, r], pk[r]) for r in range(3)]
            pi = torch.where(pbeg, px + 1, pi)
            pkind = torch.where(pbeg, EXT, pkind)

            # extend bases for both automata (one gather, one O2 extension)
            q2 = _query_at(qflat, L, torch.cat([lane, lane]),
                           torch.cat([st.i, pi]))
            qi, pqi = q2[:B], q2[B:]
            if trace is not None:
                trace.extend(torch.cat([(st.kind == EXT) & (st.i < lens)
                                        & (qi <= 3),
                                        (pkind == EXT) & (pi < lens)
                                        & (pqi <= 3)]),
                             torch.cat([st.ik1, pk[1]]),
                             torch.cat([st.ik2, pk[2]]))
            ek = fm.extend1_fwd(torch.cat([st.ik0, pk[0]]),
                                torch.cat([st.ik1, pk[1]]),
                                torch.cat([st.ik2, pk[2]]),
                                3 - q2.clamp(0, 3))
            pext = pkind == EXT
            p_end = pext & (pi >= lens)
            pamb_i = pext & ~p_end & (pqi > 3)
            pdo = pext & ~p_end & ~pamb_i
            st.step(qi, lens, minv, tuple(e[:B] for e in ek), lane, True)

            qk = [e[B:] for e in ek]
            hit = pdo & (qk[2] < max_intv) & ((pi - px) >= min_seed_len)
            emit = hit & (qk[2] > 0)
            pcan = emit & (pn < S3_CAP)
            pslot = lane * S3_CAP + pn
            for r in range(3):
                _put(seeds[r], pcan, pslot, qk[r])
            _put(sx, pcan, pslot, px)
            _put(si, pcan, pslot, pi + 1)
            pov = pov | (emit & (pn >= S3_CAP))
            pn = pn + emit.to(i32)
            pkind = torch.where(p_end, DONE, pkind)
            pnxt = pamb_i | hit
            px = torch.where(pnxt, pi + 1, px)
            pkind = torch.where(pnxt, SEEK, pkind)
            pgo = pdo & ~hit
            pk = [torch.where(pgo, qk[r], pk[r]) for r in range(3)]
            pi = torch.where(pgo, pi + 1, pi)

    sinf = ((sx[:S3].to(torch.int64) << 32) | si[:S3].to(torch.int64))
    p3 = Pass3Out(seeds[:, :S3].reshape(3, B, S3_CAP).permute(1, 2, 0)
                  .contiguous(), sinf.reshape(B, S3_CAP), pn, pov)
    if trace is not None:
        trace.done(stats)
    return st.out(B), p3
