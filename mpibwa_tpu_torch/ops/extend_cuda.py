"""Wrapper of the hand-written CUDA extension kernel (csrc/extend.cu).

The kernel replaces the TPU kernel mpibwa_tpu/ops/pallas_extend.py
``extend_batch_pallas``: the whole banded ksw_extend2 DP per problem, one
warp per problem with the DP row spread over its lanes and the eh slots in
registers (see the note at the top of csrc/extend.cu for what bounds it
and what the design does about it). It takes any 5x5 scoring matrix, so
every matrix runs through the kernel on CUDA.

``extend_batch_kernel`` takes the signature of the plain version
``ops.extend_batch.extend_batch``. On a CUDA tensor it launches the kernel
or raises; on a CPU tensor it runs the plain version. It counts its
launches in ``extend_batch_kernel.launches``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from mpibwa_tpu_torch.ops import _build
from mpibwa_tpu_torch.ops.extend_batch import ExtendOut, extend_batch

Q_MAX = 512  # largest query window (DeviceAligner.Q_BUCKETS)
T_MAX = 1024  # largest target window (DeviceAligner.T_BUCKETS)

_P = ctypes.c_void_p
_I = ctypes.c_int
_count_lock = threading.Lock()  # the C chain session calls from threads
# the kernel's C entry point: (kernel, symbol, argument types)
ENTRY = ("extend", "mpibwa_extend_batch",
         [_P] * 6 + [_I] * 7 + [_P, _P])


def _check(qs, ts, qlens, tlens, params, mat):
    dev = qs.device
    for name, t in (("ts", ts), ("qlens", qlens), ("tlens", tlens),
                    ("params", params), ("mat", mat)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, qs on {dev}")
    if qs.dtype != torch.uint8 or ts.dtype != torch.uint8:
        raise TypeError("qs and ts must be uint8 nt4 codes")
    for name, t in (("qlens", qlens), ("tlens", tlens), ("params", params),
                    ("mat", mat)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if qs.dim() != 2 or ts.dim() != 2 or ts.shape[0] != qs.shape[0]:
        raise ValueError(f"qs {tuple(qs.shape)} and ts {tuple(ts.shape)} "
                         "must be (B, Q) and (B, T)")
    B, Q = qs.shape
    T = ts.shape[1]
    if (qlens.shape != (B,) or tlens.shape != (B,) or params.shape != (B, 4)
            or mat.numel() != 25):
        raise ValueError("qlens/tlens must be (B,), params (B, 4), mat 5x5")
    if Q > Q_MAX or T > T_MAX:
        raise ValueError(f"window {Q}x{T} exceeds the kernel's "
                         f"{Q_MAX}x{T_MAX}")
    for name, t in (("qs", qs), ("ts", ts), ("qlens", qlens),
                    ("tlens", tlens), ("params", params), ("mat", mat)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def extend_batch_kernel(qs: torch.Tensor, ts: torch.Tensor,
                        qlens: torch.Tensor, tlens: torch.Tensor,
                        params: torch.Tensor, mat: torch.Tensor, o_del: int,
                        e_del: int, o_ins: int, e_ins: int) -> ExtendOut:
    """ksw_extend2 for B problems: qs (B, Q) / ts (B, T) uint8, qlens/tlens
    (B,) int32, params (B, 4) int32 (w, end_bonus, zdrop, h0), mat (5, 5)
    int32. Returns an ExtendOut of (B,) int32 tensors."""
    _check(qs, ts, qlens, tlens, params, mat)
    if qs.device.type == "cpu":
        return extend_batch(qs, ts, qlens, tlens, params, mat, o_del, e_del,
                            o_ins, e_ins)
    if qs.device.type != "cuda":
        raise ValueError(f"no extension kernel for device {qs.device}")
    B, Q = qs.shape
    T = ts.shape[1]
    dev = qs.device
    out = torch.empty((6, B), dtype=torch.int32, device=dev)
    if B == 0:
        return ExtendOut(*out.unbind(0))
    rc = _build.launch_on(dev, _build.entry(*ENTRY), qs.data_ptr(),
                          ts.data_ptr(), qlens.data_ptr(), tlens.data_ptr(),
                          params.data_ptr(), mat.data_ptr(), B, Q, T, o_del,
                          e_del, o_ins, e_ins, out.data_ptr())
    if rc != 0:
        raise RuntimeError(f"extension kernel launch failed (cudaError {rc})")
    with _count_lock:
        _WRAPPER.launches += 1
    return ExtendOut(*out.unbind(0))


extend_batch_kernel.launches = 0
# the count stays on this function object even where a caller rebinds the
# module attribute (e.g. to wrap it)
_WRAPPER = extend_batch_kernel
