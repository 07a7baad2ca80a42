"""FASTQ parsing with the reference mains' semantics.

The mpiBWA parser (mainParallel.c:1257-1304): read name is the header token
up to the first whitespace, with a trailing "/<digit>" stripped; the comment
(rest of header) is attached only with -C.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from mpibwa_tpu_torch.core.pipeline import BSeq
from mpibwa_tpu_torch.index.format import NT4_TABLE


def parse_name(header: str):
    """Returns (name, comment) from a '@'-stripped FASTQ header line."""
    sp = header.find(" ")
    if sp < 0:
        for ws in "\t":
            sp2 = header.find(ws)
            if sp2 >= 0:
                sp = sp2
                break
    if sp >= 0:
        name, comment = header[:sp], header[sp + 1 :]
    else:
        name, comment = header, None
    if len(name) >= 2 and name[-2] == "/" and name[-1].isdigit():
        name = name[:-2]
    return name, comment


def encode_seq(seq: str) -> np.ndarray:
    return NT4_TABLE[np.frombuffer(seq.encode(), dtype=np.uint8)]


def read_fastq(path: str, copy_comment: bool = False,
               limit: Optional[int] = None) -> List[BSeq]:
    out: List[BSeq] = []
    with open(path) as f:
        while True:
            h = f.readline()
            if not h:
                break
            if h in ("\n", "\r\n"):
                continue  # tolerate stray blank lines (e.g. trailing)
            seq = f.readline().rstrip("\r\n")
            f.readline()
            qual = f.readline().rstrip("\r\n")
            name, comment = parse_name(h.rstrip("\r\n")[1:])
            out.append(BSeq(name=name, seq=encode_seq(seq), qual=qual,
                            comment=comment if copy_comment else None))
            if limit and len(out) >= limit:
                break
    return out


def interleave(r1: List[BSeq], r2: List[BSeq]) -> List[BSeq]:
    assert len(r1) == len(r2)
    out: List[BSeq] = []
    for a, b in zip(r1, r2):
        out.append(a)
        out.append(b)
    return out


class FastqIndex:
    """Offset/length index of a FASTQ file: the streaming analog of the
    reference's per-read offset/size/base vectors (find_reads_size_and_
    offsets_mt, parallel_aux.c:332-476). Holds O(n_reads) integers instead
    of parsed records; chunks are materialized on demand with load()."""

    __slots__ = ("path", "offsets", "l_seq")

    def __init__(self, path: str, offsets: np.ndarray, l_seq: np.ndarray):
        self.path = path
        self.offsets = offsets  # (n+1,) int64 record-start byte offsets
        self.l_seq = l_seq  # (n,) int32 sequence lengths

    def __len__(self):
        return len(self.l_seq)

    def read_range(self, lo: int, hi: int) -> bytes:
        """The bytes of records [lo, hi): one contiguous read (the analog
        of pread_fastq_chunck, parallel_aux.c:2767)."""
        with open(self.path, "rb") as f:
            f.seek(int(self.offsets[lo]))
            return f.read(int(self.offsets[hi]) - int(self.offsets[lo]))

    def load(self, lo: int, hi: int, copy_comment: bool = False) -> List[BSeq]:
        """Materialize records [lo, hi) read by read: the route without
        the C runtime, and for chunks load_columns sends back."""
        if hi <= lo:
            return []
        data = self.read_range(lo, hi)
        out: List[BSeq] = []
        lines = data.split(b"\n")
        for i in range(hi - lo):
            h = lines[4 * i]
            seq = lines[4 * i + 1]
            qual = lines[4 * i + 3]
            if h.endswith(b"\r"):  # CRLF input
                h = h[:-1]
            if seq.endswith(b"\r"):
                seq = seq[:-1]
            if qual.endswith(b"\r"):
                qual = qual[:-1]
            name, comment = parse_name(h.decode()[1:])
            qual = qual.decode()
            out.append(BSeq(name=name,
                            seq=NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)],
                            qual=qual,
                            comment=comment if copy_comment else None))
        return out


def load_columns(ranges, copy_comment: bool = False):
    """The reads of ``ranges`` parsed in one C call into packed columns
    (native/fastq.c), as a ReadBatch; None without the C runtime, or
    when a header or quality holds a byte above 0x7f (then load() reads
    the chunk). ranges: [(FastqIndex, lo, hi)], one range, or R1's and
    R2's of the same reads, interleaved R1, R2 as in paired chunks.
    Field for field what load() gives."""
    import ctypes

    from mpibwa_tpu_torch import native
    from mpibwa_tpu_torch.io.columns import ReadBatch, ReadColumns

    counts = [hi - lo for _, lo, hi in ranges]
    if len(ranges) > 2 or len(set(counts)) > 1:
        raise ValueError(f"one range, or two of one size: {counts}")
    lib = native.get_lib()
    if lib is None:
        return None
    bufs = [idx.read_range(lo, hi) for idx, lo, hi in ranges]
    n = sum(counts)
    # capacities: the index's sequence lengths for seq and qual, the
    # rest of the bytes for names and comments; a column that outgrows
    # its capacity (a malformed record) sends the chunk to load()
    seq_cap = sum(int(idx.l_seq[lo:hi].sum()) for idx, lo, hi in ranges)
    rest = max(sum(len(b) for b in bufs) - 2 * seq_cap, 0)
    caps = (seq_cap, seq_cap, rest, rest if copy_comment else 0)
    blobs = [np.empty(c, np.uint8) for c in caps]
    offs = [np.empty(n + 1, np.int64) for _ in caps]
    has_com = np.empty(n, np.uint8)
    vp = ctypes.c_void_p
    cols = []
    for blob, off, cap in zip(blobs, offs, caps):
        cols += [vp(blob.ctypes.data), ctypes.c_int64(cap),
                 vp(off.ctypes.data)]
    b2 = bufs[1] if len(bufs) > 1 else None
    rc = lib.mpibwa_fastq_parse(
        bufs[0], len(bufs[0]), b2, len(b2) if b2 else 0, n,
        1 if copy_comment else 0, vp(NT4_TABLE.ctypes.data), *cols,
        vp(has_com.ctypes.data))
    if rc != 0:
        return None
    parts = []
    for blob, off in zip(blobs, offs):
        parts += [blob[: off[n]], off]
    return ReadBatch.of(ReadColumns(*parts, has_com))


def scan_fastq(path: str, block: int = 8 << 20) -> FastqIndex:
    """Single streaming pass building the offset/length index with bounded
    memory (numpy newline scan per block; no per-record Python objects)."""
    rec_offsets: List[np.ndarray] = []
    seq_lens: List[np.ndarray] = []
    line_no = 0  # global line counter
    line_start = 0  # byte offset where the current line starts
    pos = 0
    prev_last = 0  # last byte of the previous block (CRLF spanning blocks)
    tail2 = b""  # last two bytes of the file (trailing-blank-line check)
    with open(path, "rb") as f:
        while True:
            buf = f.read(block)
            if not buf:
                break
            arr = np.frombuffer(buf, dtype=np.uint8)
            nl = np.flatnonzero(arr == 10).astype(np.int64) + pos
            if len(nl):
                starts = np.concatenate([[line_start], nl[:-1] + 1])
                nums = line_no + np.arange(len(nl), dtype=np.int64)
                rec_offsets.append(starts[nums % 4 == 0])
                m1 = nums % 4 == 1
                lens1 = nl[m1] - starts[m1]
                if len(lens1):
                    # CRLF input: a \r before the \n is not a base
                    local = (nl[m1] - pos).astype(np.int64)
                    before = np.where(
                        local > 0,
                        arr[np.maximum(local - 1, 0)],
                        np.uint8(prev_last))
                    lens1 = lens1 - (before == 13)
                seq_lens.append(lens1.astype(np.int32))
                # 4-line-record validation: every separator line must start
                # with '+' (catches multi-line FASTQ, which would otherwise
                # misparse silently; the reference's record-boundary
                # heuristic, parallel_aux.c:307-318, makes the same
                # assumption record-wise)
                m2 = (nums % 4 == 2) & (starts >= pos) & (starts < nl)
                plus_starts = (starts[m2] - pos).astype(np.int64)
                if len(plus_starts) and not (arr[plus_starts] == 43).all():
                    bad = int(plus_starts[arr[plus_starts] != 43][0]) + pos
                    raise ValueError(
                        f"not 4-line FASTQ (separator line at byte {bad} "
                        f"does not start with '+'): {path}")
                line_no += len(nl)
                line_start = int(nl[-1]) + 1
            if len(arr) >= 2:
                tail2 = bytes(arr[-2:])
            elif len(arr) == 1:
                tail2 = tail2[-1:] + bytes(arr[-1:])
            prev_last = int(arr[-1]) if len(arr) else prev_last
            pos += len(buf)
        if line_start < pos:  # final line without trailing newline
            if line_no % 4 == 0:
                rec_offsets.append(np.array([line_start], np.int64))
            elif line_no % 4 == 1:
                seq_lens.append(np.array([pos - line_start], np.int32))
            line_no += 1
    offs = (np.concatenate(rec_offsets) if rec_offsets
            else np.zeros(0, np.int64))
    blank_tail = (int(offs[-1]) == pos - 1
                  or (int(offs[-1]) == pos - 2 and tail2 == b"\r\n")
                  ) if len(offs) else False
    if line_no % 4 == 1 and blank_tail:
        # single trailing blank line: not a record
        offs = offs[:-1]
        line_no -= 1
    if line_no % 4 != 0:
        raise ValueError(f"truncated FASTQ (line count {line_no}): {path}")
    lens = np.concatenate(seq_lens) if seq_lens else np.zeros(0, np.int32)
    assert len(offs) == len(lens)
    offsets = np.concatenate([offs, [pos]])
    return FastqIndex(path, offsets, lens)


# ---------------------------------------------------------------------------
# Shard-cooperative scanning: N shard processes each scan ~1/N of the file
# (record-boundary discovery at the split points, the @-line heuristic of
# find_reads_size_and_offsets_mt, parallel_aux.c:307-318) and exchange
# partial indexes through a filesystem rendezvous — the no-MPI analog of the
# reference's rank-striped offset discovery. Total scan bytes across shards
# ~= one file; the assembled index is bit-identical to a full scan (tested).
# ---------------------------------------------------------------------------


def _read_at_least(f, buf: bytes, need: int) -> bytes:
    while len(buf) < need:
        more = f.read(1 << 20)
        if not more:
            break
        buf += more
    return buf


def find_record_start(f, pos: int, fsize: int) -> int:
    """First FASTQ record boundary at or after byte pos.

    A line starting with '@' is a header iff the line two below starts
    with '+' (quality strings may start with '@', but sequence lines never
    start with '+'), the parallel_aux.c:307-318 heuristic."""
    if pos <= 0:
        return 0
    if pos >= fsize:
        return fsize
    f.seek(pos - 1)  # include the byte before pos so "\n@" matches at pos
    buf = b""
    off = 0
    while True:
        i = buf.find(b"\n@", off)
        if i < 0:
            old = len(buf)
            buf = _read_at_least(f, buf, len(buf) + (1 << 20))
            if len(buf) == old:
                return fsize  # no record boundary before EOF
            off = max(off, old - 1)
            continue
        # need the two following newlines + one byte to verify
        j = buf.find(b"\n", i + 2)
        if j < 0:
            old = len(buf)
            buf = _read_at_least(f, buf, len(buf) + (1 << 20))
            if len(buf) == old:
                return fsize
            continue
        k = buf.find(b"\n", j + 1)
        if k < 0 or k + 1 >= len(buf):
            old = len(buf)
            buf = _read_at_least(f, buf, len(buf) + (1 << 20))
            if len(buf) == old:
                return fsize
            continue
        if buf[k + 1 : k + 2] == b"+":
            return pos - 1 + i + 1
        off = i + 1


def _scan_range(path: str, start: int, end: int, block: int = 8 << 20):
    """scan_fastq restricted to [start, end) (must be record-aligned);
    returns (record offsets int64[n], seq lens int32[n])."""
    rec_offsets: List[np.ndarray] = []
    seq_lens: List[np.ndarray] = []
    line_no = 0
    line_start = start
    pos = start
    prev_last = 0
    with open(path, "rb") as f:
        f.seek(start)
        remaining = end - start
        while remaining > 0:
            buf = f.read(min(block, remaining))
            if not buf:
                break
            remaining -= len(buf)
            arr = np.frombuffer(buf, dtype=np.uint8)
            nl = np.flatnonzero(arr == 10).astype(np.int64) + pos
            if len(nl):
                starts = np.concatenate([[line_start], nl[:-1] + 1])
                nums = line_no + np.arange(len(nl), dtype=np.int64)
                rec_offsets.append(starts[nums % 4 == 0])
                m1 = nums % 4 == 1
                lens1 = nl[m1] - starts[m1]
                if len(lens1):
                    local = (nl[m1] - pos).astype(np.int64)
                    before = np.where(local > 0, arr[np.maximum(local - 1, 0)],
                                      np.uint8(prev_last))
                    lens1 = lens1 - (before == 13)
                seq_lens.append(lens1.astype(np.int32))
                m2 = (nums % 4 == 2) & (starts >= pos) & (starts < nl)
                plus_starts = (starts[m2] - pos).astype(np.int64)
                if len(plus_starts) and not (arr[plus_starts] == 43).all():
                    bad = int(plus_starts[arr[plus_starts] != 43][0]) + pos
                    raise ValueError(
                        f"not 4-line FASTQ (separator line at byte {bad} "
                        f"does not start with '+'): {path}")
                line_no += len(nl)
                line_start = int(nl[-1]) + 1
            prev_last = int(arr[-1]) if len(arr) else prev_last
            pos += len(buf)
        if line_start < pos:  # final line without trailing newline
            if line_no % 4 == 0:
                rec_offsets.append(np.array([line_start], np.int64))
            elif line_no % 4 == 1:
                seq_lens.append(np.array([pos - line_start], np.int32))
            line_no += 1
    offs = (np.concatenate(rec_offsets) if rec_offsets
            else np.zeros(0, np.int64))
    if line_no % 4 == 1 and len(offs) and int(offs[-1]) >= pos - 2:
        offs = offs[:-1]  # single trailing blank line
        line_no -= 1
    if line_no % 4 != 0:
        raise ValueError(
            f"truncated FASTQ (stripe [{start},{end}) line count {line_no}):"
            f" {path}")
    lens = np.concatenate(seq_lens) if seq_lens else np.zeros(0, np.int32)
    return offs, lens


def scan_fastq_sharded(path: str, shard: int, n_shards: int,
                       steal_after: float = None) -> FastqIndex:
    """Cooperative scan: claim + scan this shard's byte stripe, publish the
    partial index, assemble all stripes. Unclaimed stripes are scanned by
    whichever shard gets to them first (so a lone process never deadlocks);
    stripes claimed by a peer are polled and stolen after `steal_after`
    seconds. The assembled index equals a full scan_fastq() bit for bit."""
    import hashlib
    import json
    import tempfile
    import time

    if n_shards <= 1:
        return scan_fastq(path)
    if steal_after is None:
        steal_after = float(os.environ.get("MPIBWA_SCAN_STEAL_S", "60"))
    st = os.stat(path)
    key = hashlib.sha1(
        f"{os.path.realpath(path)}:{st.st_size}:{st.st_mtime_ns}"
        .encode()).hexdigest()[:16]
    d = os.path.join(tempfile.gettempdir(), f"mpibwa_fqidx_{key}_{n_shards}")
    os.makedirs(d, exist_ok=True)
    final = os.path.join(d, "index.npz")

    def load_final():
        with np.load(final) as z:
            return FastqIndex(path, z["offsets"], z["l_seq"])

    if os.path.exists(final):
        return load_final()
    fsize = st.st_size

    # stripe boundaries: record-aligned via the @-heuristic; computed once
    # per participant (tiny reads at the split points only)
    with open(path, "rb") as f:
        cuts = [0]
        for s in range(1, n_shards):
            cuts.append(find_record_start(f, s * fsize // n_shards, fsize))
        cuts.append(fsize)
    cuts = sorted(cuts)

    def part_path(s):
        return os.path.join(d, f"part{s}.npz")

    def scan_stripe(s):
        offs, lens = _scan_range(path, cuts[s], cuts[s + 1])
        tmp = os.path.join(d, f"part{s}.tmp{os.getpid()}.npz")
        np.savez(tmp, offsets=offs, l_seq=lens)
        os.replace(tmp, part_path(s))

    def try_claim(s):
        try:
            fd = os.open(os.path.join(d, f"claim{s}"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            return True
        except FileExistsError:
            return False

    # own stripe first, then steal any unclaimed stripe
    order = [shard % n_shards] + [s for s in range(n_shards)
                                  if s != shard % n_shards]
    for s in order:
        if not os.path.exists(part_path(s)) and try_claim(s):
            scan_stripe(s)
    # wait for peers' claimed stripes; steal on deadline
    deadline = time.time() + steal_after
    missing = [s for s in range(n_shards) if not os.path.exists(part_path(s))]
    while missing:
        time.sleep(0.05)
        missing = [s for s in missing if not os.path.exists(part_path(s))]
        if missing and time.time() > deadline:
            for s in missing:
                scan_stripe(s)
            missing = []
    parts = []
    for s in range(n_shards):
        with np.load(part_path(s)) as z:
            parts.append((z["offsets"], z["l_seq"]))
    offs = np.concatenate([p[0] for p in parts])
    lens = np.concatenate([p[1] for p in parts])
    offsets = np.concatenate([offs, [fsize]])
    if shard == 0 and not os.path.exists(final):
        tmp = os.path.join(d, f"index.tmp{os.getpid()}.npz")
        np.savez(tmp, offsets=offsets, l_seq=lens)
        os.replace(tmp, final)
    return FastqIndex(path, offsets, lens)
