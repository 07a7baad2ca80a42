"""Streaming alignment runtime: the mpiBWA main-loop equivalent.

Per-phase wall-clock timing is logged to stderr like the reference's
per-rank "rank N :::" lines (mainParallel.c:786-790, 1238-1317, aggregate
stats :3266-3291); gate with verbose=False.

Replaces the reference's MPI architecture with a device-native layout
(SURVEY §7): deterministic base-count chunks computed from a streaming
offset/length index of the FASTQ inputs (find_chunks_info boundary math,
parallel_aux.c:1082-1103, without the rank relay), chunk-granular on-demand
input (the pread_fastq_chunck analog, parallel_aux.c:2767), round-robin
chunk->shard assignment, per-shard device pipeline, and a deterministic
chunk-order merge through an async writer thread (the analog of
write_sam_mt, mainParallel.c:129-199 — but with guaranteed output order).

Peak host memory is O(index) + O(offset index) + O(in-flight chunks), not
O(input files).
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from mpibwa_tpu_torch.core import opts as O
from mpibwa_tpu_torch.io import bgzf as bgzf_mod
from mpibwa_tpu_torch.io import headers as hdr_mod
from mpibwa_tpu_torch.io.fastq import FastqIndex, load_columns, scan_fastq
from mpibwa_tpu_torch.io.fixmate import apply_fixmate
from mpibwa_tpu_torch.parallel.chunker import chunk_pe, chunk_se

SAM, BAM, BGZF = 2, 1, 0  # write_format codes (mainParallel.c:225)


def compress_chunk(data: bytes, level: int = 3) -> bytes:
    """One text blob as a self-contained run of BGZF blocks (used for
    headers; record streams go through compress_records). Chunk-aligned
    block boundaries are what make the byte extents in shard manifests
    meaningful for compressed outputs."""
    return bgzf_mod.pack_records([data], level)


def compress_records(records, level: int = 3) -> bytes:
    """One chunk's per-read SAM records as a self-contained BGZF run with
    the reference's line-boundary packing (whole records per block,
    parallel_aux.c:2941-3073)."""
    return bgzf_mod.pack_records(records, level)


class _OrderedWriter:
    """Async writer draining (chunk_idx, payload) in chunk order.

    Sink exceptions (disk full, broken pipe) are captured and re-raised
    from put()/close() instead of silently killing the thread and
    deadlocking producers on the bounded queue."""

    def __init__(self, sink):
        self.sink = sink  # callable(payload)
        self.q: "queue.Queue" = queue.Queue(maxsize=8)
        self.pending = {}
        self.next_idx = 0
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                break
            if self.error is not None:
                continue  # drain so producers never block
            idx, payload = item
            self.pending[idx] = payload
            try:
                while self.next_idx in self.pending:
                    self.sink(self.pending.pop(self.next_idx))
                    self.next_idx += 1
            except BaseException as e:  # noqa: BLE001 — re-raised in put()
                self.error = e
                self.pending.clear()

    def _check(self):
        if self.error is not None:
            raise RuntimeError("output writer failed") from self.error

    def put(self, idx: int, payload):
        self._check()
        self.q.put((idx, payload))

    def close(self):
        self.q.put(None)
        self.thread.join()
        self._check()
        assert not self.pending, "writer finished with gaps"


class ChunkPlan:
    """Deterministic chunks + lazy chunk-granular input loading."""

    def __init__(self, chunks, is_pe, untrimmed, idx1: FastqIndex,
                 idx2: Optional[FastqIndex], smartpe: bool,
                 copy_comment: bool):
        self.chunks = chunks
        self.is_pe = is_pe
        self.untrimmed = untrimmed
        self.idx1 = idx1
        self.idx2 = idx2
        self.smartpe = smartpe
        self.copy_comment = copy_comment

    def n_reads(self, ci: int) -> int:
        mult = 2 if self.is_pe else 1
        return self.chunks[ci].count * mult

    def get_batch(self, ci: int):
        """Chunk ci's reads (mates interleaved): packed columns parsed in
        one C call (io/fastq.py load_columns), else read by read."""
        ch = self.chunks[ci]
        lo, hi = ch.start, ch.start + ch.count
        if self.smartpe:
            ranges = [(self.idx1, lo * 2, hi * 2)]
        elif self.is_pe:
            ranges = [(self.idx1, lo, hi), (self.idx2, lo, hi)]
        else:
            ranges = [(self.idx1, lo, hi)]
        batch = load_columns(ranges, self.copy_comment)
        if batch is not None:
            return batch
        r1, *r2 = [idx.load(a, b, self.copy_comment) for idx, a, b in ranges]
        if not r2:
            return r1
        out = []
        for a, b in zip(r1, r2[0]):
            out.append(a)
            out.append(b)
        return out


class Runtime:
    """Single-host streaming runtime (multi-shard aware via shard/n_shards)."""

    def __init__(self, idx, opt, use_device: bool = True,
                 fixed_chunk_size: Optional[int] = None,
                 shard: int = 0, n_shards: int = 1, verbose: bool = True,
                 devices=None):
        """devices: torch devices, one aligner each (default: one on
        resolve_device()); chunks are fanned out round-robin. A device may
        repeat: several workers on one card overlap its host finalization
        with its device work and share that card's index. use_device=False
        runs the host spec engine (core/)."""
        from mpibwa_tpu_torch.core.fm import FMIndex
        from mpibwa_tpu_torch.core.refseq import RefSeq

        self.idx = idx
        self.opt = opt
        self.verbose = verbose
        self.times = {"parse": 0.0, "align": 0.0, "fixmate": 0.0,
                      "write_enqueue": 0.0}
        self.fixed_chunk_size = (fixed_chunk_size
                                 or opt.chunk_size * opt.n_threads)
        self.shard = shard
        self.n_shards = n_shards
        self.devices = devices
        # host engines: one unpacked reference per process
        fm = FMIndex.from_index(idx)
        refs = RefSeq(idx)
        if use_device:
            from mpibwa_tpu_torch.device import resolve_device
            from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
            from mpibwa_tpu_torch.pipeline.device_align import DeviceAligner

            devices = [resolve_device(d) for d in (devices or [None])]
            self.devices = devices
            dfms = {}
            for d in devices:
                if d not in dfms:
                    dfms[d] = DeviceFMIndex(idx, d)
            self.aligners = [DeviceAligner(idx, opt, dfm=dfms[d], fm=fm,
                                           refs=refs) for d in devices]
        else:
            from mpibwa_tpu_torch.core.pipeline import process_seqs

            class _HostAligner:
                def process_seqs(self, seqs, n_processed=0, pes0=None,
                                 rg_id=""):
                    process_seqs(opt, fm, refs, seqs, n_processed, pes0,
                                 rg_id)

            self.aligners = [_HostAligner()]

    # -- chunk planning ------------------------------------------------------

    def plan(self, r1_path: str, r2_path: Optional[str],
             copy_comment=False) -> ChunkPlan:
        """Scan inputs (offset index only), decide branch (untrimmed PE /
        trimmed PE / SE), and compute deterministic chunks
        (mainParallel.c's three branches)."""
        t0 = time.time()

        def scan(path):
            # multi-shard runs scan cooperatively (each shard ~1/N of the
            # bytes, stripes exchanged through a filesystem rendezvous)
            if (self.n_shards > 1
                    and os.environ.get("MPIBWA_SHARD_SCAN", "1") != "0"):
                from mpibwa_tpu_torch.io.fastq import scan_fastq_sharded

                return scan_fastq_sharded(path, self.shard, self.n_shards)
            return scan_fastq(path)

        idx1 = scan(r1_path)
        if r2_path:
            idx2 = scan(r2_path)
            if len(idx1) != len(idx2):
                raise ValueError(
                    f"[E::plan] paired inputs hold different read counts: "
                    f"{len(idx1)} vs {len(idx2)}")
            # branch selection by file size equality (mainParallel.c:730)
            untrimmed = os.path.getsize(r1_path) == os.path.getsize(r2_path)
            chunks = chunk_pe(idx1.l_seq, idx2.l_seq, self.fixed_chunk_size,
                              not untrimmed)
            self.times["parse"] += time.time() - t0
            return ChunkPlan(chunks, True, untrimmed, idx1, idx2, False,
                             copy_comment)
        if self.opt.flag & O.MEM_F_SMARTPE:
            # smart pairing (-p): one interleaved file, consecutive reads are
            # mates (mainParallel.c:306 sets the flag; the engine pairs
            # 2i/2i+1). Chunks are whole pairs so pairing never splits.
            if len(idx1) % 2:
                raise ValueError("smart pairing (-p) needs an even number "
                                 f"of reads, got {len(idx1)}")
            chunks = chunk_pe(idx1.l_seq[0::2], idx1.l_seq[1::2],
                              self.fixed_chunk_size, True)
            self.times["parse"] += time.time() - t0
            return ChunkPlan(chunks, True, False, idx1, None, True,
                             copy_comment)
        chunks = chunk_se(idx1.l_seq, self.fixed_chunk_size)
        self.times["parse"] += time.time() - t0
        return ChunkPlan(chunks, False, False, idx1, None, False,
                         copy_comment)

    # -- the unified chunk executor ------------------------------------------

    def _execute(self, plan: ChunkPlan, encode, sink, dofixmate, pes0,
                 rg_id):
        """Run this shard's chunks through the aligner(s).

        encode(text: str) -> payload; payloads are written via an ordered
        writer in chunk order. Returns the manifest: [(ci, size(payload))]
        where size is len() for bytes payloads and {file: len} for dicts."""
        chunks = plan.chunks
        order = [ci for ci in range(len(chunks))
                 if ci % self.n_shards == self.shard]
        local_idx = {ci: k for k, ci in enumerate(order)}
        prefix = []
        acc = 0
        for ci in range(len(chunks)):
            prefix.append(acc)
            acc += plan.n_reads(ci)

        writer = _OrderedWriter(sink)
        man: Dict[int, object] = {}
        lock = threading.Lock()
        nw = len(self.aligners)
        t_start = time.time()

        def run_worker(wi):
            al = self.aligners[wi]
            for k in range(wi, len(order), nw):
                ci = order[k]
                t0 = time.time()
                batch = plan.get_batch(ci)
                t1 = time.time()
                # untrimmed PE passes n_processed = 0 per chunk
                # (mainParallel.c:1314); trimmed/SE accumulate (:2355-2357)
                np_arg = 0 if (plan.is_pe and plan.untrimmed) else prefix[ci]
                al.process_seqs(batch, n_processed=np_arg, pes0=pes0,
                                rg_id=rg_id)
                t2 = time.time()
                if dofixmate and plan.is_pe:
                    apply_fixmate(batch, self.idx.anns)
                t3 = time.time()
                records = [s.sam.encode() for s in batch]
                for s in batch:
                    s.sam = None  # free
                payload = encode(records)
                size = ({fi: len(b) for fi, b in payload.items()}
                        if isinstance(payload, dict) else len(payload))
                with lock:
                    self.times["parse"] += t1 - t0
                    self.times["align"] += t2 - t1
                    self.times["fixmate"] += t3 - t2
                    man[ci] = size
                    writer.put(local_idx[ci], payload)
                if self.verbose:
                    print(f"shard {self.shard} ::: chunk {ci}: aligned "
                          f"{len(batch)} reads ({t2 - t1:.2f}s)",
                          file=sys.stderr)

        if nw == 1:
            run_worker(0)
        else:
            import concurrent.futures

            with concurrent.futures.ThreadPoolExecutor(max_workers=nw) as ex:
                for fu in [ex.submit(run_worker, wi) for wi in range(nw)]:
                    fu.result()
        writer.close()
        if self.verbose:
            tot = time.time() - t_start
            print(f"shard {self.shard} ::: processed "
                  f"{sum(plan.n_reads(ci) for ci in order)} reads, "
                  f"{len(order)}/{len(chunks)} chunks in {tot:.1f}s "
                  f"(read {self.times['parse']:.1f}s, "
                  f"align {self.times['align']:.1f}s, "
                  f"fixmate {self.times['fixmate']:.1f}s)", file=sys.stderr)
        return [(ci, man[ci]) for ci in order]

    # -- merged-output mode (mpiBWA equivalent) ------------------------------

    def run(self, r1_path: str, r2_path: Optional[str], out_path: str,
            write_format: int = SAM, dofixmate: bool = False,
            hdr_line=None, rg_line=None, pg_line=None, rg_id: str = "",
            copy_comment: bool = False, pes0=None, compression_level: int = 3):
        opt = self.opt
        plan = self.plan(r1_path, r2_path, copy_comment)
        if plan.is_pe:
            opt.flag |= O.MEM_F_PE

        ext = {SAM: ".sam", BAM: ".bam", BGZF: ".gz"}[write_format]
        path = out_path + ext
        f = open(path, "wb")
        header = hdr_mod.sam_header(self.idx.anns, hdr_line, rg_line, pg_line)
        if write_format == SAM:
            hdr_bytes = header.encode()
            encode = lambda recs: b"".join(recs)  # noqa: E731
        else:
            # BAM mode here is BGZF-of-SAM-text like the reference
            # (mainParallel.c:1509-1516, SURVEY §1-L3); each chunk is a
            # self-contained block run (whole read records per block,
            # parallel_aux.c:2941-3073) so shard manifests record real
            # compressed extents
            hdr_bytes = compress_chunk(header.encode(), compression_level)
            encode = lambda recs: compress_records(recs,  # noqa: E731
                                                   compression_level)
        self.header_len = len(hdr_bytes)
        if self.shard == 0:
            f.write(hdr_bytes)  # only shard 0 carries the header
        try:
            manifest = self._execute(plan, encode, f.write, dofixmate, pes0,
                                     rg_id)
        finally:
            if write_format != SAM:
                f.write(bgzf_mod.BGZF_EOF)
            f.close()
        self.last_manifest = manifest
        return path

    # -- by-chromosome output (mpiBWAByChr equivalent) -----------------------

    def run_by_chr(self, r1_path: str, r2_path: Optional[str], out_dir: str,
                   write_format: int = SAM, dofixmate: bool = False,
                   hdr_line=None, rg_line=None, pg_line=None, rg_id: str = "",
                   copy_comment: bool = False, pes0=None,
                   compression_level: int = 3):
        """One output per contig + discordant/unmapped (SURVEY §1-L5,
        mainParallelByChromosome.c:984-1041, 1344-1563). Sharded runs write
        complete per-shard file sets merged by merge_bychr_outputs."""
        from mpibwa_tpu_torch.io.bychr import ByChrRouter

        opt = self.opt
        plan = self.plan(r1_path, r2_path, copy_comment)
        if plan.is_pe:
            opt.flag |= O.MEM_F_PE
        router = ByChrRouter(self.idx.anns, dofixmate)
        os.makedirs(out_dir, exist_ok=True)
        ext = {SAM: ".sam", BAM: ".bam", BGZF: ".gz"}[write_format]
        header = hdr_mod.sam_header(self.idx.anns, hdr_line, rg_line, pg_line)
        if write_format == SAM:
            hdr_bytes = header.encode()
        else:
            hdr_bytes = compress_chunk(header.encode(), compression_level)
        self.header_len = len(hdr_bytes)
        files = []
        for name in router.files:
            fh = open(os.path.join(out_dir, name + ext), "wb")
            if self.shard == 0:
                fh.write(hdr_bytes)  # full @SQ set per file (:2677-2687)
            files.append(fh)

        def encode(records):
            routed = router.route_text(b"".join(records).decode())
            out = {}
            for fi, lines in routed.items():
                if write_format == SAM:
                    out[fi] = "".join(lines).encode()
                else:  # whole lines per block (line-boundary packing)
                    out[fi] = bgzf_mod.pack_records(
                        [ln.encode() for ln in lines], compression_level)
            return out

        def sink(payload: Dict[int, bytes]):
            for fi, data in payload.items():
                files[fi].write(data)

        try:
            manifest = self._execute(plan, encode, sink, dofixmate, pes0,
                                     rg_id)
        finally:
            for fh in files:
                if write_format != SAM:
                    fh.write(bgzf_mod.BGZF_EOF)  # per-file EOF (:1591-1599)
                fh.close()
        self.last_manifest = manifest
        self.out_files = list(router.files)
        return [os.path.join(out_dir, name + ext) for name in router.files]


def merge_shard_outputs(shard_paths, manifests, out_path, header_len: int,
                        write_format: int = SAM):
    """Deterministic chunk-order merge of per-shard outputs.

    shard_paths[k] was written by Runtime(shard=k, n_shards=K): shard 0's
    file starts with the header; each shard then holds its chunks in chunk
    order with byte sizes recorded in manifests[k] (compressed sizes for
    BGZF/BAM, whose chunks are self-contained block runs). The reference
    merges at write time through a shared file pointer (mainParallel.c:157,
    parallel_aux.c:2941-3170); a post-hoc extent merge is deterministic."""
    entries = []  # (chunk_idx, shard, offset, nbytes)
    for k, man in enumerate(manifests):
        off = header_len if k == 0 else 0
        for ci, nb in man:
            entries.append((ci, k, off, nb))
            off += nb
    entries.sort()
    files = [open(p, "rb") for p in shard_paths]
    with open(out_path, "wb") as out:
        out.write(files[0].read(header_len))
        for ci, k, off, nb in entries:
            files[k].seek(off)
            out.write(files[k].read(nb))
        if write_format != SAM:
            out.write(bgzf_mod.BGZF_EOF)
    for f in files:
        f.close()
    return out_path


def merge_bychr_outputs(shard_dirs, manifests, file_names, out_dir,
                        header_len: int, write_format: int = SAM):
    """Per-contig analog of merge_shard_outputs: merge each per-chr file
    across shard directories in chunk order. manifests[k] holds
    [(ci, {file_idx: nbytes})]."""
    ext = {SAM: ".sam", BAM: ".bam", BGZF: ".gz"}[write_format]
    os.makedirs(out_dir, exist_ok=True)
    out_paths = []
    for fi, name in enumerate(file_names):
        entries = []  # (ci, shard, offset, nbytes)
        for k, man in enumerate(manifests):
            off = header_len if k == 0 else 0
            for ci, sizes in man:
                sizes = {int(a): b for a, b in sizes.items()}
                nb = sizes.get(fi, 0)
                if nb:
                    entries.append((ci, k, off, nb))
                off += nb
        entries.sort()
        out_path = os.path.join(out_dir, name + ext)
        with open(out_path, "wb") as out:
            with open(os.path.join(shard_dirs[0], name + ext), "rb") as f0:
                out.write(f0.read(header_len))
            fhs = [open(os.path.join(d, name + ext), "rb")
                   for d in shard_dirs]
            for ci, k, off, nb in entries:
                fhs[k].seek(off)
                out.write(fhs[k].read(nb))
            for fh in fhs:
                fh.close()
            if write_format != SAM:
                out.write(bgzf_mod.BGZF_EOF)
        out_paths.append(out_path)
    return out_paths
