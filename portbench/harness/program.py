"""The system under test: mpibwa_tpu_torch, through the pieces its CLI uses.

``cli mem`` loads the index, builds one ``DeviceAligner`` a worker (``-t``
maps to min(t, 4) workers sharing one ``DeviceFMIndex`` on the card,
``cli.py``), plans chunks with ``scan_fastq`` and ``chunk_pe`` and runs
them through ``Runtime._execute``. The benchmark builds the same objects
here; its window (window.py) runs the chunk path of ``_execute``. This is
the one module of the benchmark that imports the program.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np

from . import genome as G

# mem's integer options the configurations use, by letter (cli.main_mem)
INT_OPTS = {"k": "min_seed_len", "w": "w", "A": "a", "B": "b", "T": "T",
            "U": "pen_unpaired", "c": "max_occ", "d": "zdrop",
            "m": "max_matesw", "s": "split_width", "G": "max_chain_gap",
            "N": "max_chain_extend", "W": "min_chain_weight",
            "y": "max_mem_intv"}


def ensure_index(cache: str, contig: str, seq: np.ndarray) -> str:
    """Index prefix of seq under cache: written, and indexed by the
    program's own `index/build.py` (the `cli index` path), on a
    checkout's first run."""
    from mpibwa_tpu_torch.index.build import build_index

    ref = os.path.join(cache, "ref.fa")
    if os.path.exists(os.path.join(cache, "done")):
        return ref
    tmp = cache + ".part"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    G.write_fasta(os.path.join(tmp, "ref.fa"), contig, seq)
    build_index(os.path.join(tmp, "ref.fa"))
    open(os.path.join(tmp, "done"), "w").close()
    shutil.rmtree(cache, ignore_errors=True)
    os.replace(tmp, cache)
    return ref


def load_index(ref: str):
    from mpibwa_tpu_torch.index.format import load_index as load

    return load(ref)


def make_opt(options: dict):
    """mem_opt as `cli mem` builds it from these options (defaults
    otherwise), for paired input."""
    from mpibwa_tpu_torch.core import opts as O

    opt = O.mem_opt_init()
    explicitly = set()
    for key, val in options.items():
        if key == "t":
            opt.n_threads = max(int(val), 1)
        elif key in INT_OPTS:
            setattr(opt, INT_OPTS[key], int(val))
            explicitly.add(INT_OPTS[key])
        elif key != "K":
            raise ValueError(f"option -{key} is not one the benchmark sets")
    O.rescale_by_a(opt, explicitly, preset=None)
    opt.mat = O.fill_scmat(opt.a, opt.b)
    opt.round_float_fields()
    opt.flag |= O.MEM_F_PE
    return opt


def n_workers(options: dict) -> int:
    """Pipelined workers a device of `cli mem -t` (MPIBWA_WORKERS unset)."""
    return min(max(int(options.get("t", 1)), 1), 4)


def chunk_bases(options: dict, opt) -> int:
    return int(options.get("K") or opt.chunk_size * opt.n_threads)


class Workers:
    """The CLI's workers on one device: one DeviceAligner each, one shared
    DeviceFMIndex (int64 positions with wide) and one set of host
    engines."""

    def __init__(self, idx, opt, count: int, device, wide: bool):
        from mpibwa_tpu_torch.core.fm import FMIndex
        from mpibwa_tpu_torch.core.refseq import RefSeq
        from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
        from mpibwa_tpu_torch.pipeline.device_align import DeviceAligner

        self.fm = FMIndex.from_index(idx)
        self.refs = RefSeq(idx)
        self.dfm = DeviceFMIndex(idx, device, force_wide=wide)
        self.idx = idx
        self.aligners = [DeviceAligner(idx, opt, dfm=self.dfm, fm=self.fm,
                                       refs=self.refs)
                         for _ in range(count)]

    def twins(self, opt) -> "list":
        """Aligners with another opt over the same index and engines."""
        from mpibwa_tpu_torch.pipeline.device_align import DeviceAligner

        return [DeviceAligner(self.idx, opt, dfm=self.dfm, fm=self.fm,
                              refs=self.refs) for _ in self.aligners]


def plan(r1: str, r2: str, chunk: int):
    """The chunk plan of `cli mem` for equal-size paired files
    (Runtime.plan's untrimmed branch)."""
    from mpibwa_tpu_torch.io.fastq import scan_fastq
    from mpibwa_tpu_torch.parallel.chunker import chunk_pe
    from mpibwa_tpu_torch.parallel.runtime import ChunkPlan

    idx1, idx2 = scan_fastq(r1), scan_fastq(r2)
    chunks = chunk_pe(idx1.l_seq, idx2.l_seq, chunk, False)
    return ChunkPlan(chunks, True, True, idx1, idx2, False, False)


def run_chunk(al, plan_, ci: int, clock, spans=None
              ) -> "tuple[list, float]":
    """One chunk as Runtime._execute runs it (untrimmed PE: n_processed 0,
    no fixmate): its records and the parse seconds. With spans, records
    the parse and the records' text as spans."""
    t0 = clock()
    batch = plan_.get_batch(ci)
    t1 = clock()
    al.process_seqs(batch, n_processed=0, pes0=None, rg_id="")
    t2 = clock()
    records = [s.sam.encode() for s in batch]
    for s in batch:
        s.sam = None
    if spans is not None:
        spans.append(("parse", t0, t1))
        spans.append(("records", t2, clock()))
    return records, t1 - t0


SEED_STAGES = ("fwd1", "bwd1", "pass2", "pass3", "sortout")


def counters(aligners) -> dict:
    """The program's own clocks and counts, summed over workers."""
    out = {"chain_s": 0.0, "emit_s": 0.0, "seed_s": 0.0,
           "fallback_reads": 0}
    for al in aligners:
        t = al.stats["t"]
        out["chain_s"] += t.get("chain", 0.0)
        out["emit_s"] += t.get("emit", 0.0)
        out["fallback_reads"] += al.stats["fallback_reads"]
        out["seed_s"] += sum(al.seeder.times.get(k, 0.0)
                             for k in SEED_STAGES)
    return out


def wrap_spans(aligners, spans: list, clock) -> None:
    """Record (name, start, end) spans around the calls into each layer:
    the seed stage, the C chain session and the C finalize."""
    def wrap(obj, attr, name):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            t0 = clock()
            try:
                return fn(*a, **k)
            finally:
                spans.append((name, t0, clock()))
        setattr(obj, attr, timed)

    for al in aligners:
        wrap(al, "_seed_stage", "seed")
        wrap(al, "_align_arrays_inner", "chain")
        chainer = al._native_chainer()
        if chainer is not None:
            wrap(chainer, "pestat_isizes", "emit")
            wrap(chainer, "finalize_packed", "emit")


def kernel_names() -> "list[str]":
    """The program's hand-written CUDA kernels, by their names in
    csrc/*.cu."""
    import mpibwa_tpu_torch

    csrc = os.path.join(os.path.dirname(mpibwa_tpu_torch.__file__), "csrc")
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    names = []
    for fn in sorted(os.listdir(csrc)):
        if fn.endswith(".cu"):
            with open(os.path.join(csrc, fn)) as fh:
                names += pat.findall(fh.read())
    return names
