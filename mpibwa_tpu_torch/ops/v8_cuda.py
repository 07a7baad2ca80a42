"""The v8 backward pass in one launch: the wrapper of the CUDA kernel of
csrc/bwd_v8.cu.

The kernel replaces the device loop of the JAX package's v8 engine
(mpibwa_tpu/ops/backward8.py ``_round8`` and the segments, compactions and
tail of ``run_backward8``, an XLA loop, not a Pallas kernel): persistent
warps take the pass's lanes in index order, one entry a thread, several
lanes to a warp, at either position dtype, ranking through the O2 table
(see the note at the top of the source for its bound and design).
``DeviceSeeder`` reaches it under MPIBWA_BWD=v8, and under
MPIBWA_BWD=auto on a CUDA int64 index, at all three v8 call sites.

``v8_pass_kernel`` takes the signature of its plain version, the port's
torch v8 ``ops.backward8.run_backward8`` (plus ``max_len``, which the
seeder's call sites pass and the kernel does not read), and returns
the same results: per-lane mem lists, or with raw=True the (n, 6) rows
[x0, x1, x2, start, end, lane] in the index dtype. Rows are chronological
within a lane, as the plain version's, and come lane after lane, where the
plain version's interleave lanes by its compactions: rows sorted stably by
lane (``lane_order``) are equal. On a CUDA tensor it launches the kernel
once or raises; on a CPU tensor it runs the plain version. It counts its
launches in ``v8_pass_kernel.launches``. A mem lives in its entry's own
slot, so no buffer fills: the only overflow it reports is the caller's
``extra_ov``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from mpibwa_tpu_torch.ops import _build
from mpibwa_tpu_torch.ops import backward8 as B8
from mpibwa_tpu_torch.ops.pulls import (lane_lists, note_pass, pack_rows,
                                        pull_rows, rounds_on_host)

LIVE, EMITTED = 1, 2  # bits of the kernel's per-entry flags

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_count_lock = threading.Lock()  # seeding runs on a helper thread
# the kernel's C entry point: (kernel, symbol, argument types); the
# leading six are DeviceFMIndex.o2_args()
ENTRY = ("bwd_v8", "mpibwa_bwd_v8",
         [_I, _P, _L, _P, _L, _L]
         + [_P, _I, _L] + [_P] * 5 + [_I] + [_P] * 6)


class V8Inputs(NamedTuple):
    """A pass's inputs as the kernel reads them, on one device."""
    q: torch.Tensor  # (NL, L) uint8 query rows
    lane_off: torch.Tensor  # (NL + 1,) int32 entry offsets (v8_inputs)
    x0: torch.Tensor  # (NL,) int32 start of each lane's call
    minv: torch.Tensor  # (NL,) int32 min_intv of each lane
    ik: torch.Tensor  # (E, 3) idt forward intervals
    live: torch.Tensor  # (E,) bool


class V8Out(NamedTuple):
    """The kernel's per-entry outputs (one slot an entry)."""
    k0: torch.Tensor  # (E,) idt x[0]
    s: torch.Tensor  # (E,) int32 size
    i: torch.Tensor  # (E,) int32 next query position; a mem starts at i+1
    flags: torch.Tensor  # (E,) uint8 LIVE | EMITTED
    # (4,) int32 [the pass's round count, the next lane to take, warps
    # done, the warps' rounds summed]; the middle two 0 between launches
    ctl: torch.Tensor


def lane_order(rows: np.ndarray) -> np.ndarray:
    """rows sorted stably by their lane column: the plain version's rows
    in the kernel's order."""
    return rows[np.argsort(rows[:, 5], kind="stable")] if len(rows) else rows


def _on(a, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)


def v8_inputs(fm, qrows_dev, entry_dev, n_lanes: int, x0,
              minv) -> V8Inputs:
    """The kernel's inputs from run_backward8's arguments, checked, on the
    entries' device; no host read. The lane column of entry_dev must be
    non-decreasing (seeding_flat.assemble_entries builds it so); the
    offsets come from it on the device, every lane ending at most at the
    pass's last live entry: the dead entries that pad a pass to its
    capacity (all in the last lane) can change nothing, and the kernel
    does not walk them."""
    ik, _, lane, live = entry_dev
    dev = ik.device
    if fm.o2_tables().device != dev:
        raise ValueError(f"the entries are on {dev}, the index on "
                         f"{fm.o2_tables().device}")
    NL = int(n_lanes)
    E = ik.shape[0]
    if qrows_dev.dtype != torch.uint8 or qrows_dev.dim() != 2 \
            or qrows_dev.shape[0] != NL:
        raise TypeError(f"qrows must be ({NL}, L) uint8, got "
                        f"{tuple(qrows_dev.shape)} {qrows_dev.dtype}")
    if ik.shape != (E, 3) or lane.shape != (E,) or live.shape != (E,):
        raise ValueError("entries must be ik (E, 3), lane (E,), live (E,)")
    if live.dtype != torch.bool:
        raise TypeError(f"live must be bool, got {live.dtype}")
    if E >= 2**31:
        raise ValueError("a v8 pass of 2**31 or more entries")
    if qrows_dev.device != dev or lane.device != dev:
        raise ValueError("qrows, lane and the entries must share a device")
    lane_off = torch.searchsorted(
        lane.contiguous(), torch.arange(NL + 1, device=dev,
                                        dtype=lane.dtype)).to(torch.int32)
    used = torch.where(live, torch.arange(1, E + 1, device=dev,
                                          dtype=torch.int32), 0).max() \
        if E else torch.zeros((), dtype=torch.int32, device=dev)
    lane_off = torch.minimum(lane_off, used)
    x0_d, minv_d = _on(x0, dev), _on(minv, dev)
    if x0_d.shape != (NL,) or minv_d.shape != (NL,):
        raise ValueError(f"x0 and minv must be ({NL},)")
    return V8Inputs(qrows_dev.contiguous(), lane_off, x0_d, minv_d,
                    ik.to(fm.idt).contiguous(), live.contiguous())


def v8_outputs(fm, E: int, dev) -> V8Out:
    """The outputs of a pass of E entries: flags (an entry past every lane
    keeps 0) and ctl zero-filled, the rest written by the kernel."""
    return V8Out(torch.empty(E, dtype=fm.idt, device=dev),
                 torch.empty(E, dtype=torch.int32, device=dev),
                 torch.empty(E, dtype=torch.int32, device=dev),
                 torch.zeros(E, dtype=torch.uint8, device=dev),
                 torch.zeros(4, dtype=torch.int32, device=dev))


def v8_launch(fm, inp: V8Inputs, out: V8Out, fn=None) -> int:
    """One launch of the kernel into out (every entry of a lane is
    written, so launches into the same outputs repeat), through fn (the C
    entry point of ENTRY; by default this checkout's). Returns the
    cudaError (0 = launched). Not counted: v8_pass_kernel counts its
    launches."""
    NL, L = inp.q.shape
    E = inp.ik.shape[0]
    return _build.launch_on(
        inp.q.device, fn or _build.entry(*ENTRY), *fm.o2_args(),
        inp.q.data_ptr(), NL, L, inp.lane_off.data_ptr(), inp.x0.data_ptr(),
        inp.minv.data_ptr(), inp.ik.data_ptr(), inp.live.data_ptr(), E,
        out.k0.data_ptr(), out.s.data_ptr(), out.i.data_ptr(),
        out.flags.data_ptr(), out.ctl.data_ptr())


def pack_v8(out: V8Out, ik: torch.Tensor, info: torch.Tensor,
            lane: torch.Tensor, min_len: int, extra_ov=None) -> torch.Tensor:
    """The emitted entries at least min_len long as v8's rows [x0, x1, x2,
    start, end, lane] in slot order (lane after lane, chronological within
    a lane: a lane's first live entry only moves down its slots), packed
    behind pulls.pack_rows's header in the index dtype; the header's
    overflow is extra_ov (a device bool) or 0."""
    idt = out.k0.dtype
    start = out.i + 1
    end = info.to(torch.int32)
    em = ((out.flags & EMITTED) != 0) & ((end - start) >= min_len)
    cols = torch.stack([out.k0, ik[:, 1].to(idt), out.s.to(idt),
                        start.to(idt), end.to(idt), lane.to(idt)], dim=1)
    return pack_rows(cols, em, extra_ov)


def v8_pass_kernel(fm, qrows_dev, entry_dev, n_lanes: int, x0, minv,
                   min_len: int = 0, raw: bool = False, est_rows: int = 0,
                   extra_ov=None, stats: "dict | None" = None,
                   max_len: "int | None" = None):
    """run_backward8 in one launch of the v8 kernel (see the module note
    and v8_rows); max_len is not read."""
    dev = entry_dev[0].device
    if dev.type == "cpu":
        return B8.run_backward8(fm, qrows_dev, entry_dev, n_lanes, x0, minv,
                                min_len=min_len, raw=raw, est_rows=est_rows,
                                extra_ov=extra_ov, stats=stats)
    if dev.type != "cuda":
        raise ValueError(f"no v8 kernel for device {dev}")
    return v8_rows(fm, qrows_dev, entry_dev, n_lanes, x0, minv, min_len,
                   raw, est_rows, extra_ov, stats, _launch)


def _launch(fm, inp: V8Inputs, out: V8Out) -> None:
    rc = v8_launch(fm, inp, out)
    if rc != 0:
        raise RuntimeError(f"v8 kernel launch failed (cudaError {rc})")
    with _count_lock:
        _WRAPPER.launches += 1


def v8_rows(fm, qrows_dev, entry_dev, n_lanes: int, x0, minv, min_len: int,
            raw: bool, est_rows: int, extra_ov, stats, launch):
    """The kernel's route around launch(fm, inputs, outputs), which fills
    the outputs of every entry of a lane: the inputs (v8_inputs), the
    launch, the rows' compaction on the device and their pull. stats, when
    given, accumulates "bwd_segments" (host reads: one, or two when more rows
    than est_rows come) and "bwd_rounds" (the pass's round count, the most
    rounds any lane ran)."""
    inp = v8_inputs(fm, qrows_dev, entry_dev, n_lanes, x0, minv)
    E = inp.ik.shape[0]
    out = v8_outputs(fm, E, inp.ik.device)
    if E > 0:
        launch(fm, inp, out)
    rounds_host = rounds_on_host(out.ctl[:1], stats)
    _, info, lane, _ = entry_dev
    rows, ov, reads = pull_rows(
        pack_v8(out, inp.ik, info, lane, min_len, extra_ov), est_rows)
    note_pass(stats, reads, rounds_host)
    return (rows, ov) if raw else lane_lists(rows, ov, n_lanes)


v8_pass_kernel.launches = 0
# the count stays on this function object even where a caller rebinds the
# module attribute (e.g. to wrap it)
_WRAPPER = v8_pass_kernel
