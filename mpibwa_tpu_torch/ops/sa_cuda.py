"""The bwt_sa walk in one launch: the wrapper of the CUDA kernel of
csrc/sa_walk.cu.

The kernel replaces the device while_loop of mpibwa_tpu/ops/fmd.py
``_sa_lookup16`` (an XLA program, not a Pallas kernel): one CUDA thread
walks one suffix-array index to its sampled row (see the note at the top
of the source for its bound and design). ``DeviceFMIndex.sa_lookup``
calls it, for the aligner's SA prefetch and its direct lookups.

``sa_walk_kernel`` takes the signature of the plain version
``ops.fmd._sa_lookup16``. On a CUDA tensor it launches the kernel once or
raises; on a CPU tensor it runs the plain version. It counts its launches
in ``sa_walk_kernel.launches``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from mpibwa_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_count_lock = threading.Lock()  # the C chain session resolves from threads
# the kernel's C entry point: (kernel, symbol, argument types)
ENTRY = ("sa_walk", "mpibwa_sa_walk",
         [_I, _P, _L, _P, _L, _L, _P, _L, _I, _P, _L, _P, _P])


def sa_walk_kernel(fm, ks: torch.Tensor) -> torch.Tensor:
    """(N,) SA indices in fm's position type -> (N,) positions: the plain
    version's arguments (o2, L2, primary, seq_len, sa, sa_intv) are taken
    from the DeviceFMIndex fm."""
    dev = ks.device
    if dev.type == "cpu":
        from mpibwa_tpu_torch.ops.fmd import _sa_lookup16

        return _sa_lookup16(fm._o2, fm.L2, fm.primary, fm.seq_len, fm.sa,
                            fm.sa_intv, ks)
    if dev.type != "cuda":
        raise ValueError(f"no SA walk kernel for device {dev}")
    if fm.o2_tables().device != dev:
        raise ValueError(f"ks is on {dev}, the index on "
                         f"{fm.o2_tables().device}")
    if ks.dtype != fm.idt or ks.dim() != 1:
        raise TypeError(f"ks must be (N,) {fm.idt}, got {tuple(ks.shape)} "
                        f"{ks.dtype}")
    intv = fm.sa_intv
    if intv <= 0 or intv & (intv - 1):
        raise ValueError(f"sa_intv {intv} is not a power of two")
    ks = ks.contiguous()
    N = ks.shape[0]
    out = torch.empty(N, dtype=fm.idt, device=dev)
    if N == 0:
        return out
    rc = _build.launch_on(dev, _build.entry(*ENTRY), *fm.o2_args(),
                          fm.sa.data_ptr(), fm.sa.shape[0],
                          intv.bit_length() - 1, ks.data_ptr(), N,
                          out.data_ptr())
    if rc != 0:
        raise RuntimeError(f"SA walk kernel launch failed (cudaError {rc})")
    with _count_lock:
        _WRAPPER.launches += 1
    return out


sa_walk_kernel.launches = 0
# the count stays on this function object even where a caller rebinds the
# module attribute (e.g. to wrap it)
_WRAPPER = sa_walk_kernel
