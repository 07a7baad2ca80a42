"""Fused occ4 + bwt_extend over the classic BWT blocks: the CUDA kernel
(csrc/occ4_extend.cu), its wrapper and its plain PyTorch version.

The kernel replaces the TPU kernel mpibwa_tpu/ops/pallas_occ4.py
``extend_pallas``: bwt_occ4 at the two ends of each interval and the
bidirectional bwt_extend arithmetic for all four bases (bwt.c:98-105,
165-186, 262-275), one thread per entry, block rows read inside the kernel,
a row shared by both ends of an interval once (see the note at the top of
the source for its bound and design). The launch path is kept short: the
C entry point is bound once (``_build.entry``) and the fused table's
arguments are cached on the index (``DeviceFMIndex.fused_args``).
``DeviceFMIndex.extend`` reaches it under MPIBWA_PALLAS=1.

``extend_kernel(fm, ik, is_back)`` takes (E, 3) int32 intervals at any E
and returns (E, 4, 3) int32, equal bit for bit to ``DeviceFMIndex.extend``
through the O2 table. On a CUDA tensor it launches the kernel or raises; on
a CPU tensor it runs the plain version ``extend_blocks``. It counts its
launches in ``extend_kernel.launches``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from mpibwa_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_count_lock = threading.Lock()  # seeding runs on a helper thread


def extend_blocks(fm, ik: torch.Tensor, is_back: int) -> torch.Tensor:
    """Plain version: ik (..., 3) int32 intervals -> (..., 4, 3), the block
    scan ``fm.occ4`` at k - 1 and k - 1 + x2 under the arithmetic of
    bwt_extend (bwt.c:262-275, ``DeviceFMIndex.extend_with``)."""
    return fm.extend_with(ik, is_back, fm.occ4)


# the kernel's C entry point: (kernel, symbol, argument types)
ENTRY = ("occ4_extend", "mpibwa_occ4_extend",
         [_P] + [_I] * 6 + [_P, _I, _I, _P, _P])


def extend_kernel(fm, ik: torch.Tensor, is_back: int) -> torch.Tensor:
    """bwt_extend of (E, 3) int32 intervals for the 4 bases -> (E, 4, 3)
    int32; fm is a DeviceFMIndex on the int32 position path."""
    if ik.dtype != torch.int32 or fm.idt != torch.int32:
        raise TypeError("the occ4 kernel takes int32 intervals of an int32 "
                        f"index, got {ik.dtype} / {fm.idt}")
    if ik.dim() != 2 or ik.shape[1] != 3:
        raise ValueError(f"ik must be (E, 3), got {tuple(ik.shape)}")
    dev = ik.device
    if dev.type == "cpu":
        return extend_blocks(fm, ik, is_back)
    if dev.type != "cuda":
        raise ValueError(f"no occ4 kernel for device {dev}")
    fdev, fargs = fm.fused_args()
    if fdev != dev:
        raise ValueError(f"ik is on {dev}, the index on {fdev}")
    if not ik.is_contiguous():
        raise ValueError("ik must be contiguous")
    E = ik.shape[0]
    out = torch.empty((E, 4, 3), dtype=torch.int32, device=dev)
    if E == 0:
        return out
    rc = _build.launch_on(dev, _build.entry(*ENTRY), *fargs, ik.data_ptr(),
                          E, 1 if is_back else 0, out.data_ptr())
    if rc != 0:
        raise RuntimeError(f"occ4 kernel launch failed (cudaError {rc})")
    with _count_lock:
        _WRAPPER.launches += 1
    return out


extend_kernel.launches = 0
# the count stays on this function object even where a caller rebinds the
# module attribute (e.g. to wrap it)
_WRAPPER = extend_kernel
