"""A chunk's reads as packed columns, and the batch that carries them.

The FASTQ chunk parser (``io/fastq.py`` ``load_columns``, ``native/fastq.c``)
writes a chunk's reads once into columns: the sequences as nt4 codes, the
qualities, the names and the comments, each a byte blob with int64
offsets (n + 1 of them, from 0). A ``ReadBatch`` is the list of reads the
aligner takes, with those columns beside it; a slice of it carries the
columns' slice. The steps that need many reads' fields at once
(``NativeFinalizer._pack_blobs``, ``device_seed._pad_batch``) take the
columns when the batch has them and loop over the reads otherwise: a
plain list of ``BSeq`` (``api.py``, the tests) has none.
"""

from __future__ import annotations

from itertools import repeat

import numpy as np

from mpibwa_tpu_torch.core.pipeline import BSeq


def _rebase(off: np.ndarray, lo: int, hi: int) -> np.ndarray:
    return off[lo : hi + 1] - off[lo]


class ReadColumns:
    """The columns of n reads: (blob, offsets) for seq (nt4 codes), qual,
    name and com (comment), and has_com (uint8[n]: the read has a comment,
    possibly empty; without it the comment is None)."""

    __slots__ = ("seq", "seq_off", "qual", "qual_off", "name", "name_off",
                 "com", "com_off", "has_com")

    def __init__(self, seq, seq_off, qual, qual_off, name, name_off, com,
                 com_off, has_com):
        self.seq, self.seq_off = seq, seq_off
        self.qual, self.qual_off = qual, qual_off
        self.name, self.name_off = name, name_off
        self.com, self.com_off = com, com_off
        self.has_com = has_com

    def __len__(self) -> int:
        return len(self.has_com)

    def slice(self, lo: int, hi: int) -> "ReadColumns":
        """Reads [lo, hi): views of the blobs, offsets rebased to 0."""
        out = []
        for blob, off in ((self.seq, self.seq_off), (self.qual, self.qual_off),
                          (self.name, self.name_off),
                          (self.com, self.com_off)):
            out += [blob[off[lo] : off[hi]], _rebase(off, lo, hi)]
        return ReadColumns(*out, self.has_com[lo:hi])

    def blobs(self):
        """(seq, seq_off, qual, qual_off, name, name_off, com, com_off), as
        NativeFinalizer._pack_blobs returns them."""
        return (self.seq, self.seq_off, self.qual, self.qual_off, self.name,
                self.name_off, self.com, self.com_off)

    @staticmethod
    def concat(parts) -> "ReadColumns":
        out = []
        for blob, off in (("seq", "seq_off"), ("qual", "qual_off"),
                          ("name", "name_off"), ("com", "com_off")):
            blobs = [getattr(p, blob) for p in parts]
            offs = [getattr(p, off) for p in parts]
            base = np.cumsum([0] + [int(o[-1]) for o in offs[:-1]])
            out += [np.concatenate(blobs),
                    np.concatenate([offs[0]] + [o[1:] + b for o, b
                                                in zip(offs[1:], base[1:])])]
        return ReadColumns(*out, np.concatenate([p.has_com for p in parts]))

    @staticmethod
    def of_copies(read: BSeq, k: int) -> "ReadColumns":
        """k copies of one read."""
        out = []
        for field in (np.asarray(read.seq, np.uint8),
                      (read.qual or "").encode(), read.name.encode(),
                      (read.comment or "").encode()):
            a = np.frombuffer(field, np.uint8) if isinstance(field, bytes) \
                else field
            out += [np.tile(a, k),
                    np.arange(k + 1, dtype=np.int64) * len(a)]
        return ReadColumns(*out, np.full(k, read.comment is not None,
                                         np.uint8))


class PackedRead(BSeq):
    """Read i of a batch's columns: a BSeq whose fields are sliced from
    the columns when they are read (names, qualities and comments are
    ASCII: the parser sends any other chunk to the per-read loader).
    ``sam`` is the one field it holds."""

    __slots__ = ("_cols", "_i")

    def __init__(self, cols: ReadColumns, i: int):
        self._cols = cols
        self._i = i

    def _text(self, blob, off) -> str:
        return blob[off[self._i] : off[self._i + 1]].tobytes().decode()

    @property
    def seq(self) -> np.ndarray:
        c = self._cols
        return c.seq[c.seq_off[self._i] : c.seq_off[self._i + 1]]

    @property
    def qual(self) -> str:
        return self._text(self._cols.qual, self._cols.qual_off)

    @property
    def name(self) -> str:
        return self._text(self._cols.name, self._cols.name_off)

    @property
    def comment(self):
        c = self._cols
        return self._text(c.com, c.com_off) if c.has_com[self._i] else None


class ReadBatch(list):
    """A list of reads (BSeq) with their packed columns in ``cols``; a
    slice keeps the columns' slice, and ``padded`` appends copies of a
    read to both."""

    __slots__ = ("cols",)

    def __init__(self, reads, cols: ReadColumns):
        super().__init__(reads)
        self.cols = cols

    @classmethod
    def of(cls, cols: ReadColumns) -> "ReadBatch":
        """One PackedRead a read of cols."""
        return cls(map(PackedRead, repeat(cols), range(len(cols))), cols)

    def __getitem__(self, k):
        if isinstance(k, slice) and k.step in (None, 1):
            lo, hi, _ = k.indices(len(self))
            hi = max(hi, lo)
            return ReadBatch(list.__getitem__(self, k),
                             self.cols.slice(lo, hi))
        return list.__getitem__(self, k)

    def padded(self, read: BSeq, k: int) -> "ReadBatch":
        return ReadBatch(list(self) + [read] * k, ReadColumns.concat(
            [self.cols, ReadColumns.of_copies(read, k)]))


def columns_of(seqs):
    """The batch's columns, or None for a plain list of reads."""
    return getattr(seqs, "cols", None)


def seq_source(seqs):
    """The reads' codes as device_seed._pad_batch takes them: the batch's
    columns, or one array a read."""
    cols = columns_of(seqs)
    return cols if cols is not None else [s.seq for s in seqs]
