"""Native (C) host-runtime components, loaded via ctypes.

The reference's host runtime is C (fixmate.c, tokenizer.c, parallel_aux.c);
these are our native equivalents for the text/IO hot paths. The shared
library is built on demand with the system compiler into this package
directory; every caller falls back to the exact Python implementation when
the library is unavailable (MPIBWA_NATIVE=0 forces the fallback), and both
paths are tested against the same goldens.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "_libmpibwa.so")
_SOURCES = ["fixmate.c", "sais.c", "finalize.c", "fastq.c"]
_HEADERS = ["sais_core.h"]

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    srcs = [os.path.join(_DIR, s) for s in _SOURCES]
    newest = max(os.path.getmtime(os.path.join(_DIR, f))
                 for f in _SOURCES + _HEADERS)
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= newest):
        return True
    cc = os.environ.get("CC", "cc")
    # build beside the target and rename: concurrent processes (test
    # workers, shards) never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [cc, "-O2", "-fPIC", "-shared", "-pthread", "-o", tmp] \
        + srcs + ["-lm"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def get_lib():
    """Returns the loaded library or None (Python fallback)."""
    global _lib, _tried
    if os.environ.get("MPIBWA_NATIVE", "1") == "0":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.mpibwa_fixmate_pair.restype = ctypes.c_int
        lib.mpibwa_fixmate_pair.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpibwa_buf_free.restype = None
        lib.mpibwa_buf_free.argtypes = [ctypes.c_char_p]
        lib.mpibwa_sais_u8.restype = ctypes.c_int
        lib.mpibwa_sais_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.mpibwa_sais64_u8.restype = ctypes.c_int
        lib.mpibwa_sais64_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.mpibwa_lrand48_fill.restype = None
        lib.mpibwa_lrand48_fill.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_void_p,
        ]
        # finalization runtime (finalize.c)
        P = ctypes.c_void_p
        I64 = ctypes.c_int64
        # FASTQ chunk parser (fastq.c)
        lib.mpibwa_fastq_parse.restype = ctypes.c_int
        lib.mpibwa_fastq_parse.argtypes = [
            ctypes.c_char_p, I64, ctypes.c_char_p, I64, I64, ctypes.c_int,
            P, P, I64, P, P, I64, P, P, I64, P, P, I64, P, P]
        lib.fin_ctx_new.restype = P
        lib.fin_ctx_new.argtypes = [P, ctypes.c_int64, ctypes.c_int32,
                                    P, P, P, P, P, P, P, P, P, P]
        lib.fin_ctx_free.restype = None
        lib.fin_ctx_free.argtypes = [P]
        lib.fin_buf_free.restype = None
        lib.fin_buf_free.argtypes = [P]
        lib.fin_batch.restype = ctypes.c_int
        lib.fin_batch.argtypes = [P, ctypes.c_int, ctypes.c_int64,
                                  P, P, P, P, P, P, P, P, P, P,
                                  ctypes.c_int64, ctypes.c_char_p, P, P,
                                  ctypes.POINTER(P), P]
        lib.fin_test_global.restype = ctypes.c_int
        lib.fin_test_global.argtypes = [P, ctypes.c_int, P, ctypes.c_int, P,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, P, P, P]
        lib.fin_test_align2.restype = ctypes.c_int
        lib.fin_test_align2.argtypes = [P, ctypes.c_int, P, ctypes.c_int, P,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, P]
        lib.fin_test_extend_batch.restype = ctypes.c_int
        lib.fin_test_extend_batch.argtypes = [
            P, P, P, P, ctypes.c_int, ctypes.c_int, ctypes.c_int, P,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, P, P]
        # chaining session (finalize.c chain stage)
        lib.fin_chain_begin.restype = P
        lib.fin_chain_begin.argtypes = [P, ctypes.c_int64, P, P, P, P,
                                        ctypes.c_int, P, ctypes.POINTER(P)]
        lib.fin_chain_sa.restype = ctypes.c_int
        lib.fin_chain_sa.argtypes = [P, P, P, ctypes.POINTER(P),
                                     ctypes.POINTER(P)]
        lib.fin_chain_rights.restype = ctypes.c_int
        lib.fin_chain_rights.argtypes = [P, P, P, P, ctypes.POINTER(P),
                                         ctypes.POINTER(P)]
        lib.fin_chain_finish.restype = ctypes.c_int
        lib.fin_chain_finish.argtypes = [P, P, P, ctypes.POINTER(P), P]
        lib.fin_chain_end.restype = None
        lib.fin_chain_end.argtypes = [P]
        lib.fin_pestat.restype = None
        lib.fin_pestat.argtypes = [P, P, P, ctypes.c_int64, ctypes.c_int,
                                   P, P, P, ctypes.POINTER(P)]
        lib.fin_pe_stats.restype = None
        lib.fin_pe_stats.argtypes = [ctypes.POINTER(ctypes.c_double),
                                     ctypes.c_int]
        _lib = lib
        return _lib


def pe_emit_stats(reset: bool = False) -> "dict | None":
    """PE-emit phase seconds accumulated inside fin_batch (finalize.c
    fin_pe_stats): rescue SW, mark-primary+pair, XA, reg2aln (CIGAR/NM/MD),
    SAM text, total batch wall. None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = (ctypes.c_double * 6)()
    lib.fin_pe_stats(buf, 1 if reset else 0)
    keys = ("rescue_s", "pair_s", "xa_s", "reg2aln_s", "samtext_s",
            "total_s")
    return dict(zip(keys, [float(x) for x in buf]))


def fixmate_pair_native(sam1: str, sam2: str, names) -> tuple | None:
    """C fixmate over one pair's SAM text; None -> caller uses Python."""
    lib = get_lib()
    if lib is None:
        return None
    b1 = sam1.encode()
    b2 = sam2.encode()
    arr = (ctypes.c_char_p * len(names))(*[n.encode() for n in names])
    o1 = ctypes.c_char_p()
    o2 = ctypes.c_char_p()
    l1 = ctypes.c_int()
    l2 = ctypes.c_int()
    rc = lib.mpibwa_fixmate_pair(b1, len(b1), b2, len(b2), arr, len(names),
                                 ctypes.byref(o1), ctypes.byref(l1),
                                 ctypes.byref(o2), ctypes.byref(l2))
    if rc != 0:
        return None
    try:
        r1 = ctypes.string_at(o1, l1.value).decode()
        r2 = ctypes.string_at(o2, l2.value).decode()
    finally:
        lib.mpibwa_buf_free(o1)
        lib.mpibwa_buf_free(o2)
    return r1, r2


def sais_u8(s_bytes) -> "object | None":
    """SA-IS over a uint8 numpy array (alphabet inferred); returns an
    int32 suffix array (n < 2^31) or int64 (GRCh38-scale doubled
    sequences), or None (caller uses the numpy prefix-doubling
    fallback)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(s_bytes, dtype=np.uint8)
    n = len(arr)
    K = int(arr.max()) + 1 if n else 1
    if n >= (1 << 31) - 16:
        sa = np.empty(n, np.int64)
        rc = lib.mpibwa_sais64_u8(arr.ctypes.data_as(ctypes.c_void_p),
                                  sa.ctypes.data_as(ctypes.c_void_p),
                                  ctypes.c_int64(n), ctypes.c_int64(K))
    else:
        sa = np.empty(n, np.int32)
        rc = lib.mpibwa_sais_u8(arr.ctypes.data_as(ctypes.c_void_p),
                                sa.ctypes.data_as(ctypes.c_void_p),
                                ctypes.c_int64(n), ctypes.c_int32(K))
    if rc != 0:
        return None
    return sa


def lrand48_fill_native(rng, n: int):
    """n sequential lrand48()&3 draws advancing rng.x (index/build.py's
    LRand48), or None -> caller uses the Python loop."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(max(n, 0), np.uint8)
    if n > 0:
        state = ctypes.c_uint64(rng.x)
        lib.mpibwa_lrand48_fill(ctypes.byref(state), ctypes.c_int64(n),
                                out.ctypes.data_as(ctypes.c_void_p))
        rng.x = int(state.value)
    return out
