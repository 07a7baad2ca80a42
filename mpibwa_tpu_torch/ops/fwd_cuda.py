"""The forward SMEM automata in one launch: wrappers of the CUDA kernels of
csrc/fwd_automata.cu.

The kernels replace the device while_loops of mpibwa_tpu/ops/seeding.py
``forward_p3`` and ``forward_pass`` (XLA programs, not Pallas kernels):
a group of four threads runs each automaton of a read to its end, pass 1
and pass 3 in warps of their own (see the note at the top of the source
for its bound and design). ``DeviceSeeder`` calls them
for pass 1 (with pass 3 when max_mem_intv > 0) and for pass 2.

``forward_p3_kernel`` and ``forward_pass_kernel`` take the signatures of
the plain versions ``ops.seeding.forward_p3`` and ``forward_pass`` and
return the same tuples. On a CUDA tensor each launches its kernel once or
raises; on a CPU tensor it runs the plain version. They count their
launches in ``forward_p3_kernel.launches`` and
``forward_pass_kernel.launches``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from mpibwa_tpu_torch.ops import _build, seeding
from mpibwa_tpu_torch.ops.seeding import (C_CAP, F_CAP, S3_CAP, FwdOut,
                                          Pass3Out)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_count_lock = threading.Lock()  # seeding runs on a helper thread
# the leading arguments of both entry points: DeviceFMIndex.o2_args()
_O2 = [_I, _P, _L, _P, _L, _L]
# the kernels' C entry points: (kernel, symbol, argument types)
ENTRY_PASS = ("fwd_automata", "mpibwa_forward_pass",
              _O2 + [_P, _I, _L, _P, _P, _P, _I, _I, _I] + [_P] * 9)
ENTRY_P3 = ("fwd_automata", "mpibwa_forward_p3",
            _O2 + [_P, _I, _L, _P, _P, _I, _I, _I, _I, _L] + [_P] * 13)


def _inputs(fm, q, lens, min_intv):
    """(q, lens int32, min_intv in the index's position type), checked
    and contiguous, for a launch on q's CUDA device."""
    dev = q.device
    if fm.o2_tables().device != dev:
        raise ValueError(f"q is on {dev}, the index on "
                         f"{fm.o2_tables().device}")
    if q.dtype != torch.uint8 or q.dim() != 2:
        raise TypeError("q must be (B, L) uint8 nt4 codes")
    B = q.shape[0]
    if lens.shape != (B,) or min_intv.shape != (B,):
        raise ValueError("lens and min_intv must be (B,)")
    return (q.contiguous(),
            lens.to(device=dev, dtype=torch.int32).contiguous(),
            min_intv.to(device=dev, dtype=fm.idt).contiguous())


def _fwd_out(fm, B: int, dev) -> FwdOut:
    i32 = torch.int32
    return FwdOut(torch.zeros((B, F_CAP, 3), dtype=fm.idt, device=dev),
                  torch.zeros((B, F_CAP), dtype=i32, device=dev),
                  torch.zeros(B, dtype=i32, device=dev),
                  torch.zeros((B, C_CAP), dtype=i32, device=dev),
                  torch.zeros((B, C_CAP), dtype=i32, device=dev),
                  torch.zeros((B, C_CAP), dtype=i32, device=dev),
                  torch.zeros(B, dtype=i32, device=dev),
                  torch.zeros(B, dtype=torch.bool, device=dev))


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed (cudaError {rc})")


def forward_pass_kernel(fm, q: torch.Tensor, lens: torch.Tensor,
                        min_intv: torch.Tensor, chain: bool = True,
                        starts: torch.Tensor = None) -> FwdOut:
    """ops.seeding.forward_pass in one launch of forward_pass_kernel: q
    (B, L) uint8 nt4 codes (pad >= 4), lens (B,) int32, min_intv (B,),
    starts (B,) int32 initial x (default 0); chain=False runs exactly one
    call a lane."""
    dev = q.device
    if dev.type == "cpu":
        return seeding.forward_pass(fm, q, lens, min_intv, chain, starts)
    if dev.type != "cuda":
        raise ValueError(f"no forward kernel for device {dev}")
    q, lens, minv = _inputs(fm, q, lens, min_intv)
    B, L = q.shape
    if starts is not None:
        if starts.shape != (B,):
            raise ValueError("starts must be (B,)")
        starts = starts.to(device=dev, dtype=torch.int32).contiguous()
    out = _fwd_out(fm, B, dev)
    if B == 0:
        return out
    rc = _build.launch_on(
        dev, _build.entry(*ENTRY_PASS), *fm.o2_args(), q.data_ptr(), B, L,
        lens.data_ptr(), minv.data_ptr(),
        None if starts is None else starts.data_ptr(), 1 if chain else 0,
        F_CAP, C_CAP, *(t.data_ptr() for t in out))
    _check_rc(rc, "forward_pass")
    with _count_lock:
        _WRAPPERS[0].launches += 1
    return out


def forward_p3_kernel(fm, q: torch.Tensor, lens: torch.Tensor,
                      min_intv: torch.Tensor, min_seed_len: int,
                      max_intv: int) -> "tuple[FwdOut, Pass3Out]":
    """ops.seeding.forward_p3 (the chained pass-1 automaton and the pass-3
    sweep) in one launch of forward_p3_kernel."""
    dev = q.device
    if dev.type == "cpu":
        return seeding.forward_p3(fm, q, lens, min_intv, min_seed_len,
                                  max_intv)
    if dev.type != "cuda":
        raise ValueError(f"no forward kernel for device {dev}")
    q, lens, minv = _inputs(fm, q, lens, min_intv)
    B, L = q.shape
    out = _fwd_out(fm, B, dev)
    p3 = Pass3Out(torch.zeros((B, S3_CAP, 3), dtype=fm.idt, device=dev),
                  torch.zeros((B, S3_CAP), dtype=torch.int64, device=dev),
                  torch.zeros(B, dtype=torch.int32, device=dev),
                  torch.zeros(B, dtype=torch.bool, device=dev))
    if B == 0:
        return out, p3
    rc = _build.launch_on(
        dev, _build.entry(*ENTRY_P3), *fm.o2_args(), q.data_ptr(), B, L,
        lens.data_ptr(), minv.data_ptr(), F_CAP, C_CAP, S3_CAP,
        int(min_seed_len), int(max_intv), *(t.data_ptr() for t in out),
        *(t.data_ptr() for t in p3))
    _check_rc(rc, "forward_p3")
    with _count_lock:
        _WRAPPERS[1].launches += 1
    return out, p3


forward_pass_kernel.launches = 0
forward_p3_kernel.launches = 0
# the counts stay on these function objects even where a caller rebinds
# the module attributes (e.g. to wrap them)
_WRAPPERS = (forward_pass_kernel, forward_p3_kernel)
