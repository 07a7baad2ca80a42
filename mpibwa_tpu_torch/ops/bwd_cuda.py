"""Backward-SMEM passes in one launch: the CUDA kernel (csrc/bwd_pass.cu),
its wrapper, its plain PyTorch pass and the function that runs a pass.

The kernel replaces the TPU kernel mpibwa_tpu/ops/pallas_bwd.py
``_round_call`` (one round of bwt.c:326-345 over every lane) together with
the device while_loop of ``backward_full`` that runs it round after round
and the gathers it does ahead of every round (see the note at the top of
the source for its bound and design). ``DeviceSeeder`` reaches it under
MPIBWA_BWD=auto on a CUDA int32 index, and under MPIBWA_BWD=pallas.

The state of a backward pass is one (7, E) int32 tensor over the E entries
of all lanes, flat and lane-contiguous, longest match first, at its real
length: rows ``IK0, IK1, IK2`` (the bi-interval), ``LIVE``, ``I`` (the query
position the entry extends to next; where an entry died it stays, so a
mem's start is I + 1), ``LAST`` (start of the lane's last mem, BIG before
the first) and ``EMITTED`` (the entry is a mem). ``BwdLanes`` holds what
does not change over the rounds.

``bwd_round`` is the plain version of one round and ``bwd_pass`` of a whole
pass. ``bwd_pass_kernel(fm, lanes, state)`` runs a pass in place and
returns the state. On a CUDA tensor it launches the kernel once or raises;
on a CPU tensor it runs ``bwd_pass``. It counts its launches in
``bwd_pass_kernel.launches``. ``run_backward_fused`` drives one pass and
returns per-lane mem lists or, for the seeder's arrays route, the rows of
the mems, filtered and compacted on the device.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from mpibwa_tpu_torch.ops import _build
from mpibwa_tpu_torch.ops.occ4_cuda import extend_blocks
from mpibwa_tpu_torch.ops.pulls import (lane_lists, note_pass, pack_rows,
                                        pull_rows, rounds_on_host)
from mpibwa_tpu_torch.ops.seeding_flat import (_seg_excl_cumsum,
                                               _seg_prev_keeper,
                                               _segment_start)

IK0, IK1, IK2, LIVE, I, LAST, EMITTED = range(7)
BIG = 1 << 30  # LAST before a lane's first mem
# the kernel's register instances: entries a lane holds in registers, in
# slots of 32 (a longer lane is walked in chunks from device memory)
SLOTS = (1, 2, 4, 8)

_P = ctypes.c_void_p
_I = ctypes.c_int
_count_lock = threading.Lock()  # seeding runs on a helper thread


class BwdLanes(NamedTuple):
    qrows: torch.Tensor  # (NL, L) uint8 query codes of each lane's read
    lane_off: torch.Tensor  # (NL + 1,) int32 entry offsets, last = E
    minv: torch.Tensor  # (NL,) int32 min_intv of each lane
    lane_e: torch.Tensor  # (E,) int64 lane of each entry
    max_len: int  # entries of the longest lane (picks the slot count)


def make_lanes(qrows: torch.Tensor, lane_off: torch.Tensor,
               minv: torch.Tensor, E: int,
               max_len: "int | None" = None) -> BwdLanes:
    """lane_e from the offsets (lane_off[-1] == E): the lane of entry e is
    the first lane that ends past e (zero-length lanes own no entry).
    max_len, when not given, is read from lane_off."""
    e_idx = torch.arange(E, device=lane_off.device, dtype=lane_off.dtype)
    lane_e = torch.searchsorted(lane_off[1:].contiguous(), e_idx, right=True)
    if max_len is None:
        max_len = int((lane_off[1:] - lane_off[:-1]).max()) \
            if lane_off.numel() > 1 else 0
    return BwdLanes(qrows.contiguous(), lane_off.contiguous(),
                    minv.contiguous(), lane_e, int(max_len))


def slot_count(max_len: int, slots: "tuple[int, ...]" = SLOTS) -> int:
    """The kernel instance for a launch: the fewest slots of 32 entries
    that hold the longest lane, at most slots[-1] (slots: a kernel's
    register instances, this kernel's by default)."""
    return next((s for s in slots if 32 * s >= max_len), slots[-1])


def init_state(ik: torch.Tensor, live: torch.Tensor, x0: torch.Tensor,
               lane_e: torch.Tensor) -> torch.Tensor:
    """(7, E) entry state: ik (E, 3) int32, live (E,) bool, x0 (NL,) int32
    start position of each lane's call."""
    E = ik.shape[0]
    st = torch.zeros((7, E), dtype=torch.int32, device=ik.device)
    st[IK0:IK2 + 1] = ik.t()
    st[LIVE] = live.to(torch.int32)
    st[I] = x0[lane_e] - 1
    st[LAST] = BIG
    return st


def bwd_round(fm, lanes: BwdLanes, state: torch.Tensor) -> torch.Tensor:
    """Plain version of one round: a new (7, E) state. The per-lane carries
    of the kernel are segmented scans over the flat arrays here."""
    E = state.shape[1]
    L = lanes.qrows.shape[1]
    lane = lanes.lane_e
    dev = state.device
    ik = state[IK0:IK2 + 1].t()
    live = state[LIVE] != 0
    i_e = state[I]
    valid = (i_e >= 0) & (i_e < L)
    qi = torch.where(
        valid, lanes.qrows[lane, i_e.clamp(0, L - 1).long()].to(torch.int32),
        4)
    has_c = (i_e >= 0) & (qi < 4)
    ok = extend_blocks(fm, ik, 1)  # (E, 4, 3)
    okc = ok[torch.arange(E, device=dev), qi.clamp(0, 3).long()]
    keeper = live & has_c & (okc[:, 2] >= lanes.minv[lane])

    starts = torch.zeros(E, dtype=torch.bool, device=dev)
    offs = lanes.lane_off[:-1].long()
    starts[offs[offs < E]] = True
    seg0 = _segment_start(starts)
    first_live = live & (_seg_excl_cumsum(live.to(torch.int32), seg0) == 0)
    emit = first_live & ~keeper & ((i_e + 1) < state[LAST])
    # the new start reaches the rest of the lane: only entries after the
    # emitter can still be live
    em = emit.to(torch.int32)
    seen = (_seg_excl_cumsum(em, seg0) + em) > 0
    # dedup (bwt.c:338): a keeper whose previous keeper has the same size
    has_prev, prev = _seg_prev_keeper(keeper, seg0)
    append = keeper & (~has_prev | (okc[:, 2] != okc[prev, 2]))

    out = state.clone()
    out[IK0:IK2 + 1] = torch.where(append[:, None], okc, ik).t()
    out[LIVE] = append.to(torch.int32)
    out[I] = torch.where(append, i_e - 1, i_e)
    out[LAST] = torch.where(seen, i_e + 1, state[LAST])
    out[EMITTED] = state[EMITTED] | em
    return out


def bwd_pass(fm, lanes: BwdLanes, state: torch.Tensor,
             rounds: "torch.Tensor | None" = None) -> torch.Tensor:
    """Plain version of a whole pass: ``bwd_round`` until no entry is live,
    at most L + 2 rounds (every live entry dies or moves one base down the
    read each round). Returns the new state; rounds, a (1,) int32 tensor
    when given, becomes the larger of its value and the rounds run."""
    L = lanes.qrows.shape[1]
    r = 0
    while r < L + 2 and bool(state[LIVE].any()):
        state = bwd_round(fm, lanes, state)
        r += 1
    if rounds is not None:
        rounds.clamp_(min=r)
    return state


# the kernel's C entry point: (kernel, symbol, argument types)
ENTRY = ("bwd_pass", "mpibwa_bwd_pass",
         [_P] + [_I] * 6 + [_P, _I, _P, _P, _I, _I, _P, _I, _P, _P])


def _check(fm, lanes: BwdLanes, state: torch.Tensor, rounds):
    dev = state.device
    if fm.idt != torch.int32:
        raise TypeError("the backward pass kernel needs the int32 position "
                        "path")
    want = (("state", state, torch.int32), ("qrows", lanes.qrows, torch.uint8),
            ("lane_off", lanes.lane_off, torch.int32),
            ("minv", lanes.minv, torch.int32))
    if rounds is not None:
        want += (("rounds", rounds, torch.int32),)
    for name, t, dt in want:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, state on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    NL = lanes.qrows.shape[0]
    if (state.dim() != 2 or state.shape[0] != 7 or lanes.qrows.dim() != 2
            or lanes.lane_off.shape != (NL + 1,)
            or lanes.minv.shape != (NL,)
            or (rounds is not None and rounds.shape != (1,))):
        raise ValueError("state must be (7, E), qrows (NL, L), lane_off "
                         "(NL + 1,), minv (NL,), rounds (1,)")


def bwd_pass_kernel(fm, lanes: BwdLanes, state: torch.Tensor,
                    rounds: "torch.Tensor | None" = None) -> torch.Tensor:
    """A whole backward pass over every lane, in place; returns state.
    rounds, a (1,) int32 tensor when given, becomes the larger of its value
    and the pass's round count (the most rounds any lane ran)."""
    _check(fm, lanes, state, rounds)
    if state.device.type == "cpu":
        state.copy_(bwd_pass(fm, lanes, state, rounds))
        return state
    if state.device.type != "cuda":
        raise ValueError(f"no backward pass kernel for device "
                         f"{state.device}")
    fdev, fargs = fm.fused_args()
    if fdev != state.device:
        raise ValueError(f"state is on {state.device}, the index on {fdev}")
    NL, L = lanes.qrows.shape
    E = state.shape[1]
    if NL == 0 or E == 0:
        return state
    rc = _build.launch_on(state.device, _build.entry(*ENTRY), *fargs,
                          lanes.qrows.data_ptr(), L, lanes.lane_off.data_ptr(),
                          lanes.minv.data_ptr(), NL, slot_count(lanes.max_len),
                          state.data_ptr(), E,
                          None if rounds is None else rounds.data_ptr())
    if rc != 0:
        raise RuntimeError(f"backward pass kernel launch failed "
                           f"(cudaError {rc})")
    with _count_lock:
        _WRAPPER.launches += 1
    return state


bwd_pass_kernel.launches = 0
# the count stays on this function object even where a caller rebinds the
# module attribute (e.g. to wrap it)
_WRAPPER = bwd_pass_kernel


def pack_emitted(state: torch.Tensor, info_end: torch.Tensor,
                 lane_e: torch.Tensor, min_len: int = 0) -> torch.Tensor:
    """The emitted entries at least min_len long as rows [x0, x1, x2,
    start, end, lane] in flat order: lane after lane and, within a lane, in
    emission order (the slot of a lane's first live entry only moves down
    over the rounds). On the device, behind a header row [count, 0, 0, 0,
    0, 0]: a (1 + E + 1, 6) int32 tensor, the last row a dump (pack_rows)."""
    start = state[I] + 1
    end = info_end.to(torch.int32)
    em = (state[EMITTED] != 0) & ((end - start) >= min_len)
    cols = torch.stack([state[IK0], state[IK1], state[IK2], start, end,
                        lane_e.to(torch.int32)], dim=1)
    return pack_rows(cols, em)


def entry_state(qrows_dev, entry_dev, x0_np, minv_np, lane_off_np
                ) -> "tuple[BwdLanes, torch.Tensor]":
    """(lanes, state) of a backward pass from the seeder's tables (see
    run_backward_fused)."""
    ik, _, _, live = entry_dev
    dev = ik.device

    def up(a, dt):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(a).astype(dt))).to(dev)

    lane_off_np = np.asarray(lane_off_np)
    max_len = int(np.diff(lane_off_np).max()) if len(lane_off_np) > 1 else 0
    lanes = make_lanes(qrows_dev, up(lane_off_np, np.int32),
                       up(minv_np, np.int32), int(ik.shape[0]), max_len)
    return lanes, init_state(ik.to(torch.int32), live, up(x0_np, np.int32),
                             lanes.lane_e)


def run_backward_fused(fm, qrows_dev, entry_dev, n_lanes: int, x0_np,
                       minv_np, lane_off_np, interpret: bool = False,
                       stats: "dict | None" = None, raw: bool = False,
                       min_len: int = 0, est_rows: "int | None" = None):
    """A whole backward pass in one launch, with the contract of
    seeding_flat.run_backward_flat.

    qrows_dev: (NL, L) uint8 read rows; entry_dev: (ik (E, 3) int32, info
    (E,), lane (E,), live (E,) bool) from assemble_entries at the real entry
    count E; x0_np/minv_np: (NL,) numpy; lane_off_np: (NL + 1,) entry
    offsets. interpret=True runs the plain version ``bwd_pass`` on whatever
    device the tensors lie on. Mems shorter than min_len are dropped on the
    device; the rest come to the host in one pull with the first est_rows
    rows (pull_rows; by default every entry when min_len is 0, which keeps
    every mem, else n_lanes // 8 + 1024, several times the mems 101-bp
    reads give at min_len 19). stats, when given, accumulates
    "bwd_rounds" (the pass's round count) and "bwd_segments" (host reads
    of the mems).
    Returns (per-lane mem lists [(x0, x1, x2, info)], overflow (NL,) bool,
    all false: a mem lives in its entry's own slot, so no buffer fills),
    or with raw=True ((n, 6) int32 rows [x0, x1, x2, start, end, lane],
    chronological within a lane, False)."""
    if entry_dev[0].shape[0] == 0:
        if raw:
            return np.zeros((0, 6), np.int32), False
        return [[] for _ in range(n_lanes)], np.zeros(n_lanes, bool)
    lanes, state = entry_state(qrows_dev, entry_dev, x0_np, minv_np,
                               lane_off_np)
    rounds = torch.zeros(1, dtype=torch.int32, device=state.device)
    if interpret:
        state = bwd_pass(fm, lanes, state, rounds)
    else:
        state = bwd_pass_kernel(fm, lanes, state, rounds)
    rounds_host = rounds_on_host(rounds, stats)
    if est_rows is None:
        est_rows = state.shape[1] if min_len <= 0 else n_lanes // 8 + 1024
    rows, ov, reads = pull_rows(
        pack_emitted(state, entry_dev[1], lanes.lane_e, min_len), est_rows)
    note_pass(stats, reads, rounds_host)
    return (rows, ov) if raw else lane_lists(rows, ov, n_lanes)
