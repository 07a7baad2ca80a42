"""Alignment options: mem_opt_t equivalent with bwa-mem defaults.

Defaults mirror mem_opt_init (bwamem.c:48-84); the -x
presets and -A rescaling semantics mirror mainParallel.c:398-440.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

# flag bits (bwamem.h:14-23)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_REF_HDR = 0x100
MEM_F_SOFTCLIP = 0x200
MEM_F_SMARTPE = 0x400
MEM_F_PRIMARY5 = 0x800
MEM_F_KEEP_SUPP_MAPQ = 0x1000

MEM_MAPQ_COEF = 30.0

# global verbosity (the bwa_verbose global, bwa.c); CLI -v sets it
bwa_verbose = 3


def fill_scmat(a: int, b: int) -> np.ndarray:
    """bwa_fill_scmat (bwa.c:109-118): 5x5 scoring matrix."""
    mat = np.zeros(25, dtype=np.int8)
    k = 0
    for i in range(4):
        for j in range(4):
            mat[k] = a if i == j else -b
            k += 1
        mat[k] = -1  # ambiguous base
        k += 1
    for _ in range(5):
        mat[k] = -1
        k += 1
    return mat


@dataclasses.dataclass
class MemOpt:
    a: int = 1
    b: int = 4
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    pen_unpaired: int = 17
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100
    zdrop: int = 100
    max_mem_intv: int = 20
    T: int = 30
    flag: int = 0
    min_seed_len: int = 19
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    split_factor: float = 1.5
    split_width: int = 10
    max_occ: int = 500
    max_chain_gap: int = 10000
    n_threads: int = 1
    chunk_size: int = 10000000
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    XA_drop_ratio: float = 0.80
    mask_level_redun: float = 0.95
    mapQ_coef_len: float = 50.0
    mapQ_coef_fac: int = 0  # int in C (bwamem.h:51) — truncates log(50)
    max_ins: int = 10000
    max_matesw: int = 50
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 200
    mat: np.ndarray = None

    def __post_init__(self):
        if self.mapQ_coef_fac == 0:
            # C: o->mapQ_coef_fac = log(o->mapQ_coef_len) assigned to int
            self.mapQ_coef_fac = int(math.log(self.mapQ_coef_len))
        if self.mat is None:
            self.mat = fill_scmat(self.a, self.b)
        self.round_float_fields()

    def round_float_fields(self):
        """mem_opt_t stores these as C float (bwamem.h:46-51); all downstream
        arithmetic promotes them to double, so the value used is
        double(float32(x)) — e.g. 0.80f == 0.800000011920929. Call again after
        mutating any of these fields (CLI parsing does)."""
        for f in ("split_factor", "mask_level", "drop_ratio", "XA_drop_ratio",
                  "mask_level_redun", "mapQ_coef_len"):
            setattr(self, f, float(np.float32(getattr(self, f))))

    def mat55(self) -> np.ndarray:
        return self.mat.reshape(5, 5)


def mem_opt_init() -> MemOpt:
    return MemOpt()


def apply_preset(opt: MemOpt, name: str, explicitly_set: set) -> None:
    """-x presets (mainParallel.c:398-426). explicitly_set holds option names
    the user passed, which presets must not clobber (opt0 shadow logic)."""

    def setd(key: str, val):
        if key not in explicitly_set:
            setattr(opt, key, val)

    if name == "intractg":
        setd("o_del", 16)
        setd("o_ins", 16)
        setd("b", 9)
        setd("pen_clip5", 5)
        setd("pen_clip3", 5)
    elif name in ("pacbio", "pbref", "ont2d"):
        setd("o_del", 1)
        setd("e_del", 1)
        setd("o_ins", 1)
        setd("e_ins", 1)
        setd("split_factor", 10.0)
        if name == "ont2d":
            setd("b", 1)
            setd("min_chain_weight", 20)
            setd("min_seed_len", 14)
            setd("pen_clip5", 0)
            setd("pen_clip3", 0)
        else:
            setd("b", 1)
            setd("min_chain_weight", 40)
            setd("min_seed_len", 17)
            setd("pen_clip5", 0)
            setd("pen_clip3", 0)
    else:
        raise ValueError(f"unknown preset {name}")
    opt.mat = fill_scmat(opt.a, opt.b)


def rescale_by_a(opt: MemOpt, explicitly_set: set, preset: str = None) -> None:
    """-A rescaling (mainParallel.c:429-440): scale penalties not explicitly
    set by the user when -A (match score) was changed. Applies only when no
    -x preset was given (the C code's if/else structure)."""
    if preset is not None or "a" not in explicitly_set:
        return
    sc = opt.a
    if "b" not in explicitly_set:
        opt.b *= sc
    if "T" not in explicitly_set:
        opt.T *= sc
    if "o_del" not in explicitly_set:
        opt.o_del *= sc
    if "e_del" not in explicitly_set:
        opt.e_del *= sc
    if "o_ins" not in explicitly_set:
        opt.o_ins *= sc
    if "e_ins" not in explicitly_set:
        opt.e_ins *= sc
    if "zdrop" not in explicitly_set:
        opt.zdrop *= sc
    if "pen_clip5" not in explicitly_set:
        opt.pen_clip5 *= sc
    if "pen_clip3" not in explicitly_set:
        opt.pen_clip3 *= sc
    if "pen_unpaired" not in explicitly_set:
        opt.pen_unpaired *= sc
    opt.mat = fill_scmat(opt.a, opt.b)
