"""The system under test: mpibwa_tpu_torch, through the pieces its CLI uses.

``cli mem`` loads the index, builds one ``DeviceAligner`` a worker (``-t``
maps to min(t, 4) workers sharing one ``DeviceFMIndex`` on the card,
``cli.py``), plans chunks with ``Runtime.plan`` and runs them through
``Runtime._execute``. The benchmark builds the same objects here; its
window (window.py) runs the chunk path of ``_execute``. This is the one
module of the benchmark that imports the program.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np

from . import genome as G

# mem's options that set mem_opt, by letter, as cli.main_mem parses them
INT_OPTS = {"k": "min_seed_len", "w": "w", "A": "a", "B": "b", "T": "T",
            "U": "pen_unpaired", "c": "max_occ", "d": "zdrop",
            "m": "max_matesw", "s": "split_width", "G": "max_chain_gap",
            "N": "max_chain_extend", "W": "min_chain_weight",
            "y": "max_mem_intv"}
FLOAT_OPTS = {"r": "split_factor", "D": "drop_ratio"}
PAIR_OPTS = {"O": ("o_del", "o_ins"), "E": ("e_del", "e_ins"),
             "L": ("pen_clip5", "pen_clip3")}  # INT[,INT]
FLAG_OPTS = {"P": ("MEM_F_NOPAIRING",), "a": ("MEM_F_ALL",),
             "p": ("MEM_F_PE", "MEM_F_SMARTPE"), "M": ("MEM_F_NO_MULTI",),
             "S": ("MEM_F_NO_RESCUE",), "Y": ("MEM_F_SOFTCLIP",),
             "V": ("MEM_F_REF_HDR",),
             "5": ("MEM_F_PRIMARY5", "MEM_F_KEEP_SUPP_MAPQ"),
             "q": ("MEM_F_KEEP_SUPP_MAPQ",)}


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


def make_opt(options: dict, paired: bool):
    """mem_opt as `cli mem` builds it from these options (defaults
    otherwise), in their order: each option as cli.main_mem sets it, then
    the -x preset, else the -A rescaling, then the scoring matrix; with
    MEM_F_PE for paired input, as Runtime.run adds it. Options by letter:
    a number or "INT,INT" string as on the command line, true for a
    switch, x a preset's name; K is the chunk size, not an opt field."""
    import math

    from mpibwa_tpu_torch.cli import _split_two
    from mpibwa_tpu_torch.core import opts as O

    opt = O.mem_opt_init()
    explicitly = set()
    preset = None

    def seti(name, v):
        setattr(opt, name, v)
        explicitly.add(name)

    for key, val in options.items():
        if key == "t":
            opt.n_threads = max(int(val), 1)
        elif key == "x":
            preset = str(val)
        elif key in INT_OPTS:
            seti(INT_OPTS[key], int(val))
        elif key in FLOAT_OPTS:
            seti(FLOAT_OPTS[key], float(val))
        elif key == "X":
            opt.mask_level = float(val)
        elif key in PAIR_OPTS:
            v1, v2 = _split_two(str(val))
            first, second = PAIR_OPTS[key]
            seti(first, v1)
            seti(second, v1 if v2 is None else v2)
        elif key in FLAG_OPTS:
            if val is not True:
                raise ValueError(f"switch -{key} takes true, not {val!r}")
            for name in FLAG_OPTS[key]:
                opt.flag |= getattr(O, name)
        elif key == "h":
            explicitly |= {"max_XA_hits", "max_XA_hits_alt"}
            parts = str(val).replace(";", ",").split(",")
            opt.max_XA_hits = opt.max_XA_hits_alt = int(parts[0])
            if len(parts) > 1 and parts[1]:
                opt.max_XA_hits_alt = int(parts[1])
        elif key == "Q":
            explicitly.add("mapQ_coef_len")
            opt.mapQ_coef_len = float(int(val))
            opt.mapQ_coef_fac = (int(math.log(opt.mapQ_coef_len))
                                 if opt.mapQ_coef_len > 0 else 0)
        elif key != "K":
            raise ValueError(f"option -{key} sets no field of mem_opt")
    if preset is not None:
        O.apply_preset(opt, preset, explicitly)
    else:
        O.rescale_by_a(opt, explicitly, preset=None)
    opt.mat = O.fill_scmat(opt.a, opt.b)
    opt.round_float_fields()
    if paired:
        opt.flag |= O.MEM_F_PE
    return opt


def mem_argv(options: dict) -> "list[str]":
    """The `cli mem` arguments of these options."""
    argv = []
    for key, val in options.items():
        argv += [f"-{key}"] if val is True else [f"-{key}", str(val)]
    return argv


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


def plan(paths: "list[str]", chunk: int, opt):
    """The chunk plan of `cli mem` for one FASTQ file or two, by
    Runtime.plan itself (one process, no shards)."""
    import types

    from mpibwa_tpu_torch.parallel.runtime import Runtime

    runtime = types.SimpleNamespace(n_shards=1, shard=0, opt=opt,
                                    fixed_chunk_size=chunk,
                                    times={"parse": 0.0})
    return Runtime.plan(runtime, paths[0], paths[1] if len(paths) > 1
                        else None)


def run_chunk(al, plan_, ci: int, clock, spans=None, n_processed: int = 0
              ) -> "tuple[list, float]":
    """One chunk as Runtime._execute runs it (no fixmate), with its
    n_processed: its records, one a read, and the parse seconds. With
    spans, records the parse and the records' text as spans."""
    t0 = clock()
    batch = plan_.get_batch(ci)
    t1 = clock()
    al.process_seqs(batch, n_processed=n_processed, pes0=None, rg_id="")
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
