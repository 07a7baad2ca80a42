"""BGZF block writer (bgzf.c semantics: 64 KiB blocks + EOF magic).

The reference's "BAM" output mode is BGZF-compressed SAM text (SURVEY §1-L3,
mainParallel.c:1509-1516) — the same writer serves -b and -g, differing only
in which header bytes are prepended. Blocks hold whole SAM records up to the
64 KiB payload bound (compress_and_write_bgzf_thread packs line-wise,
parallel_aux.c:2941-3073).
"""

from __future__ import annotations

import struct
import zlib

MAX_BLOCK_SIZE = 0x10000  # bgzf.c:59
# 28-byte BGZF EOF marker (appended by the mains, mainParallel.c:1509-1516)
BGZF_EOF = bytes([
    0x1F, 0x8B, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xFF, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1B, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00,
])
# leave headroom like deflate_block (BLOCK_HEADER/FOOTER_LENGTH = 18 + 8)
_PAYLOAD_MAX = MAX_BLOCK_SIZE - 26 - 64


def bgzf_block(data: bytes, level: int = 3) -> bytes:
    """One BGZF block: gzip member with BC extra field carrying BSIZE."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, zlib.Z_DEFAULT_STRATEGY)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25  # header(18) + footer(8) - 1
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 0x08, 0x04,  # gzip magic, deflate, FEXTRA
        0, 0, 0xFF,  # mtime, xfl, os
        6,  # xlen
        0x42, 0x43, 2,  # BC, slen
        bsize,
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                         len(data) & 0xFFFFFFFF)
    return header + comp + footer


class BGZFWriter:
    """Record-preserving BGZF stream writer."""

    def __init__(self, fileobj, level: int = 3):
        self.f = fileobj
        self.level = level
        self.buf = bytearray()

    def write_record(self, rec: bytes):
        if len(self.buf) + len(rec) > _PAYLOAD_MAX and self.buf:
            self.flush_block()
        if len(rec) > _PAYLOAD_MAX:  # oversized record: split raw
            for off in range(0, len(rec), _PAYLOAD_MAX):
                self.buf += rec[off : off + _PAYLOAD_MAX]
                self.flush_block()
        else:
            self.buf += rec

    def flush_block(self):
        if self.buf:
            self.f.write(bgzf_block(bytes(self.buf), self.level))
            self.buf = bytearray()

    def close(self, write_eof: bool = True):
        self.flush_block()
        if write_eof:
            self.f.write(BGZF_EOF)


class BGZFReader:
    """BGZF stream reader (bgzf.c read path: bgzf_read_block/bgzf_read/
    bgzf_seek semantics, bgzf.c:403-568).

    Supports sequential ``read``/``readline`` and random access through
    *virtual file offsets*: ``(compressed_block_offset << 16) | within_block``
    — the same coffset/uoffset packing the reference's bgzf_tell/bgzf_seek
    use, so offsets interoperate with htslib-style indexes."""

    def __init__(self, fileobj):
        self.f = fileobj
        self._block_addr = 0   # compressed offset of the current block
        self._block = b""      # decompressed payload of the current block
        self._off = 0          # cursor within self._block
        self._eof = False

    # -- block machinery ---------------------------------------------------
    def _read_block(self) -> bool:
        """Load the next block; False at physical EOF."""
        self._block_addr = self.f.tell()
        header = self.f.read(18)
        if not header:
            self._block, self._off, self._eof = b"", 0, True
            return False
        if len(header) < 18 or header[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError("invalid BGZF block header")
        # locate BSIZE in the extra field (SI1=66 SI2=67, bgzf.c:326-341)
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = header[12:18] + (self.f.read(xlen - 6) if xlen > 6 else b"")
        if len(extra) < xlen:
            raise ValueError("truncated BGZF extra field")
        bsize = -1
        i = 0
        while i + 4 <= xlen:
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2 : i + 4])[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1
                break
            i += 4 + slen
        if bsize < 0:
            raise ValueError("BGZF BC subfield missing")
        comp = self.f.read(bsize - 12 - xlen - 8)
        tail = self.f.read(8)
        if len(tail) < 8:
            raise ValueError("truncated BGZF block")
        crc, isize = struct.unpack("<II", tail)
        data = zlib.decompress(comp, -15)
        if len(data) != isize or (zlib.crc32(data) & 0xFFFFFFFF) != crc:
            raise ValueError("BGZF block CRC/length mismatch")
        self._block, self._off = data, 0
        if not data:  # EOF marker block (or any empty block)
            return self._read_block()
        return True

    def _fill(self) -> bool:
        while self._off >= len(self._block):
            if self._eof or not self._read_block():
                return False
        return True

    # -- stream API ---------------------------------------------------------
    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            if not self._fill():
                break
            take = len(self._block) - self._off
            if n >= 0:
                take = min(take, n - len(out))
            out += self._block[self._off : self._off + take]
            self._off += take
        return bytes(out)

    def readline(self) -> bytes:
        out = bytearray()
        while self._fill():
            j = self._block.find(b"\n", self._off)
            if j >= 0:
                out += self._block[self._off : j + 1]
                self._off = j + 1
                return bytes(out)
            out += self._block[self._off :]
            self._off = len(self._block)
        return bytes(out)

    def __iter__(self):
        while True:
            line = self.readline()
            if not line:
                return
            yield line

    # -- virtual offsets (bgzf_tell/bgzf_seek, bgzf.c:63-65,544-568) ---------
    def tell(self) -> int:
        return (self._block_addr << 16) | (self._off & 0xFFFF)

    def seek(self, voffset: int):
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        self.f.seek(coffset)
        self._eof = False
        if not self._read_block():
            raise ValueError("BGZF seek past end of file")
        if uoffset > len(self._block):
            raise ValueError("BGZF within-block offset out of range")
        self._off = uoffset

    def close(self):
        self.f.close()


def is_bgzf(path) -> bool:
    """True when the file starts with a BGZF (gzip+FEXTRA+BC) header
    (bgzf_check_bgzf semantics, bgzf.c:66-88)."""
    with open(path, "rb") as f:
        head = f.read(18)
    return (len(head) >= 18 and head[:4] == b"\x1f\x8b\x08\x04"
            and head[12:14] == b"\x42\x43")


def pack_records(records, level: int = 3) -> bytes:
    """Whole-record block packing with the reference writer's rules
    (compress_and_write_bgzf_thread, parallel_aux.c:3000-3057): each block
    greedily takes whole records while the uncompressed payload stays
    <= MAX_BLOCK_SIZE; the record that would overflow starts the next
    block. Records larger than one block are split at the payload bound
    (the reference's fixed 64 KiB buffer cannot represent that case).
    Returns a self-contained run of BGZF blocks ending on a record
    boundary."""
    out = bytearray()
    buf = bytearray()
    for rec in records:
        if buf and len(buf) + len(rec) > MAX_BLOCK_SIZE:
            out += bgzf_block(bytes(buf), level)
            buf.clear()
        if len(rec) > MAX_BLOCK_SIZE:
            for off in range(0, len(rec), _PAYLOAD_MAX):
                piece = rec[off : off + _PAYLOAD_MAX]
                if len(piece) == _PAYLOAD_MAX:
                    out += bgzf_block(piece, level)
                else:
                    buf += piece  # tail rides with the following records
        else:
            buf += rec
    if buf:
        out += bgzf_block(bytes(buf), level)
    return bytes(out)
