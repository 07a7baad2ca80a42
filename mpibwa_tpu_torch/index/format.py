"""bwa-index file formats and the flat device image.

Reads the on-disk index produced by ``bwa index`` (the same files the
reference loads via ``bwa_idx_load_from_disk``, bwa.c:262)
and packs them into flat NumPy arrays ready to be placed in device memory.

File formats (reference citations):
  .bwt  — primary u64, L2[1..4] 4xu64, interleaved occ/BWT u32 array
          (bwt.c:443-462, dump at bwt.c:385).
          Layout per 128-base block (OCC_INTERVAL=128, bwt.h:35-37):
          16 u32 = 4 little-endian u64 cumulative occ counts followed by
          8 u32 holding 128 bases, 2 bits each, most-significant first
          (bwt_bwt/bwt_B0 macros, bwt.h:72-78).
  .sa   — primary u64, 4xu64 skipped, sa_intv u64, seq_len u64, then
          sa[1..n_sa-1] u64; sa[0] is implicitly -1
          (bwt.c:421-441).
  .ann  — text: "l_pac n_seqs seed" then per sequence two lines
          (bntseq.c:99-137).
  .amb  — text: "l_pac n_seqs n_holes" then one line per hole
          (bntseq.c:141-156).
  .pac  — 2-bit packed forward reference, 4 bases/byte, MSB-first
          (_get_pac, bntseq.h + bntseq.c:398-420).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

OCC_INTV_SHIFT = 7
OCC_INTERVAL = 1 << OCC_INTV_SHIFT  # 128
OCC_INTV_MASK = OCC_INTERVAL - 1
BLOCK_U32 = 16  # 8 u32 of occ (4 LE u64) + 8 u32 of packed bases

# base -> 2-bit code table, same mapping as nst_nt4_table for ACGT
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i


@dataclasses.dataclass
class ContigAnn:
    """One reference sequence record (bntann1_t, bntseq.h:41-48)."""

    offset: int
    length: int
    n_ambs: int
    gi: int
    is_alt: int
    name: str
    anno: str


@dataclasses.dataclass
class AmbHole:
    """One ambiguity hole (bntamb1_t, bntseq.h:50-54)."""

    offset: int
    length: int
    amb: str


@dataclasses.dataclass
class BwaIndex:
    """Full index: FM-index + reference metadata + packed reference.

    Equivalent content to the reference's bwaidx_t (bwa.h:20-28), held as
    flat NumPy arrays so it can be shipped to device memory unchanged.
    """

    primary: int
    L2: np.ndarray  # int64[5], L2[0] == 0, cumulative base counts
    seq_len: int  # == l_pac * 2 (forward + reverse strand)
    bwt: np.ndarray  # uint32[(n_blocks) * 16], interleaved occ+BWT
    sa_intv: int
    sa: np.ndarray  # uint64[n_sa]; sa[0] == 2**64-1 sentinel
    l_pac: int
    anns: List[ContigAnn]
    ambs: List[AmbHole]
    pac: np.ndarray  # uint8[ceil(l_pac/4)] 2-bit packed forward ref
    # unpacked forward reference (uint8[l_pac], one base per byte), present
    # when loaded from a .tpumap image: memory-mapped read-only, so N
    # co-located shard processes share ONE physical copy through the page
    # cache (the map_indexes shared-window analog, parallel_aux.c:1745-1838)
    ref_fwd: "np.ndarray | None" = None

    @property
    def n_sa(self) -> int:
        return len(self.sa)

    @property
    def n_seqs(self) -> int:
        return len(self.anns)

    @property
    def bwt_size(self) -> int:
        return len(self.bwt)


def load_bwt(path: str):
    raw = np.fromfile(path, dtype=np.uint8)
    head = raw[:40].view(np.uint64)
    primary = int(head[0])
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = head[1:5].astype(np.int64)
    bwt = raw[40:].view(np.uint32).copy()
    seq_len = int(L2[4])
    return primary, L2, seq_len, bwt


def load_sa(path: str, primary: int, seq_len: int):
    raw = np.fromfile(path, dtype=np.uint8)
    head = raw[:56].view(np.uint64)
    if int(head[0]) != primary:
        raise ValueError("SA-BWT inconsistency: primary differs")
    sa_intv = int(head[5])
    if int(head[6]) != seq_len:
        raise ValueError("SA-BWT inconsistency: seq_len differs")
    n_sa = (seq_len + sa_intv) // sa_intv
    sa = np.empty(n_sa, dtype=np.uint64)
    sa[0] = np.uint64(0xFFFFFFFFFFFFFFFF)  # bwt_restore_sa sets sa[0]=-1
    body = raw[56:].view(np.uint64)
    if len(body) != n_sa - 1:
        raise ValueError(f".sa holds {len(body)} entries, want {n_sa - 1}")
    sa[1:] = body
    return sa_intv, sa


def load_ann(path: str):
    with open(path) as f:
        toks = f.read().split("\n")
    l_pac, n_seqs, _seed = (int(x) for x in toks[0].split())
    anns: List[ContigAnn] = []
    for i in range(n_seqs):
        line1 = toks[1 + 2 * i].split(None, 2)
        gi = int(line1[0])
        name = line1[1]
        anno = line1[2] if len(line1) > 2 and line1[2] != "(null)" else ""
        off, ln, n_ambs = (int(x) for x in toks[2 + 2 * i].split())
        anns.append(ContigAnn(off, ln, n_ambs, gi, 0, name, anno))
    return l_pac, anns


def load_amb(path: str):
    with open(path) as f:
        toks = [t for t in f.read().split("\n") if t]
    l_pac, _n_seqs, n_holes = (int(x) for x in toks[0].split())
    ambs: List[AmbHole] = []
    for i in range(n_holes):
        off, ln, ch = toks[1 + i].split()
        ambs.append(AmbHole(int(off), int(ln), ch))
    return l_pac, ambs


def load_pac(path: str, l_pac: int) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    need = (l_pac + 3) // 4
    return raw[:need].copy()


def load_alt(prefix: str, anns: List[ContigAnn]) -> None:
    """Mark ALT contigs from a .alt file if present (bns_restore,
    bntseq.c:177-208)."""
    path = prefix + ".alt"
    if not os.path.exists(path):
        return
    by_name = {a.name: a for a in anns}
    with open(path) as f:
        for line in f:
            name = line.split("\t")[0].strip()
            if name and not name.startswith("@") and name in by_name:
                by_name[name].is_alt = 1


def load_index(prefix: str) -> BwaIndex:
    """Load a full bwa index from ``prefix``.{bwt,sa,ann,amb,pac}."""
    primary, L2, seq_len, bwt = load_bwt(prefix + ".bwt")
    sa_intv, sa = load_sa(prefix + ".sa", primary, seq_len)
    l_pac, anns = load_ann(prefix + ".ann")
    _, ambs = load_amb(prefix + ".amb")
    load_alt(prefix, anns)
    pac = load_pac(prefix + ".pac", l_pac)
    if l_pac * 2 != seq_len:
        raise ValueError(f"l_pac {l_pac} inconsistent with seq_len {seq_len}")
    return BwaIndex(primary, L2, seq_len, bwt, sa_intv, sa, l_pac, anns, ambs, pac)


# ---------------------------------------------------------------------------
# Flat device image (.tpumap): the analog of mpiBWAIdx's .map blob
# (pidx.c:52-63, layout bwa.c:310-345) but defined as a
# versioned, pointer-free container of aligned arrays that can be memory-
# mapped zero-copy and fed to jnp.asarray per array.
# ---------------------------------------------------------------------------

_MAGIC = b"TPUMAP01"
_ALIGN = 256


def save_image(idx: BwaIndex, path: str) -> None:
    meta = {
        "primary": idx.primary,
        "L2": [int(x) for x in idx.L2],
        "seq_len": idx.seq_len,
        "sa_intv": idx.sa_intv,
        "l_pac": idx.l_pac,
        "anns": [dataclasses.asdict(a) for a in idx.anns],
        "ambs": [dataclasses.asdict(a) for a in idx.ambs],
        "arrays": {},
    }
    arrays = {"bwt": idx.bwt, "sa": idx.sa, "pac": idx.pac,
              "ref": (idx.ref_fwd if idx.ref_fwd is not None
                      else unpack_pac(idx.pac, idx.l_pac))}
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(b"\x00" * 8)  # placeholder for meta offset
        pos = 16
        for name, arr in arrays.items():
            pad = (-pos) % _ALIGN
            f.write(b"\x00" * pad)
            pos += pad
            meta["arrays"][name] = {
                "offset": pos,
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
            }
            data = arr.tobytes()
            f.write(data)
            pos += len(data)
        meta_bytes = json.dumps(meta).encode()
        meta_off = pos
        f.write(meta_bytes)
        f.seek(8)
        f.write(meta_off.to_bytes(8, "little"))


def load_image(path: str, mmap: bool = True) -> BwaIndex:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a TPUMAP image")
        meta_off = int.from_bytes(f.read(8), "little")
        f.seek(meta_off)
        meta = json.loads(f.read().decode())
    if mmap:
        buf = np.memmap(path, dtype=np.uint8, mode="r")
    else:
        buf = np.fromfile(path, dtype=np.uint8)
    arrs = {}
    for name, spec in meta["arrays"].items():
        dt = np.dtype(spec["dtype"])
        count = int(np.prod(spec["shape"])) if spec["shape"] else 1
        off = spec["offset"]
        arrs[name] = buf[off : off + count * dt.itemsize].view(dt).reshape(spec["shape"])
    return BwaIndex(
        primary=meta["primary"],
        L2=np.asarray(meta["L2"], dtype=np.int64),
        seq_len=meta["seq_len"],
        bwt=arrs["bwt"],
        sa_intv=meta["sa_intv"],
        sa=arrs["sa"],
        l_pac=meta["l_pac"],
        anns=[ContigAnn(**a) for a in meta["anns"]],
        ambs=[AmbHole(**a) for a in meta["ambs"]],
        pac=arrs["pac"],
        ref_fwd=arrs.get("ref"),  # absent in pre-round-3 images
    )


def unpack_pac(pac: np.ndarray, l_pac: int) -> np.ndarray:
    """Expand the 2-bit packed reference to one base per byte (forward)."""
    shifts = np.array([6, 4, 2, 0], dtype=np.uint8)
    out = (pac[:, None] >> shifts[None, :]) & 3
    return out.reshape(-1)[:l_pac].astype(np.uint8)
