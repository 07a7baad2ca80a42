"""One cell's run: set-up, the measured window, the numbers, the check.

Set-up makes the reference from the configuration's genome seed (and on
a checkout's first run writes it and builds its index under
build/portbench/), writes the seed's FASTQ pool into TMPDIR, loads the
index, builds the workers and warms them up with one chunk each. The
window then cycles through the pool (window.py). Once it has closed, the
peak memory is read, the program's state freed, and the reference judges
a sample of the records (reference.py).
"""

from __future__ import annotations

import gc
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

from . import genome as G
from . import program
from . import reference
from . import trace as T
from .simulate import fastq_bytes, pairs_per_chunk, simulate_pairs
from .spec import ROOT
from .window import Sink, clock, run_window

JAX_NAMES = ("jax", "jaxlib", "flax", "mpibwa_tpu")
# the CPU rehearsal's sizes: a small genome, small chunks, a short pool
REHEARSAL = {"genome_length": 2_000_000, "K": 100_000, "pool_chunks": 6,
             "sample_pairs": 300}


def seed_entropy(seed: int) -> int:
    return seed % (1 << 64)


def reference_genome(spec: dict, n: int):
    """(codes, index prefix) of the configuration's genome group at length
    n, cached under build/portbench/ inside the checkout by the group's
    digest: the first run makes the sequence, writes it and has the
    program build its index."""
    contig = spec["contig"]
    cache = os.path.join(ROOT, "build", "portbench",
                         f"genome-{contig}-{n}-{G.spec_tag(spec)}")
    codes_path = os.path.join(cache, "codes.npy")
    if os.path.exists(codes_path):
        return (np.load(codes_path),
                program.ensure_index(cache, contig, None))
    seq = G.make_chr1(spec, n)
    ref = program.ensure_index(cache, contig, seq)
    codes = G.to_codes(seq)
    np.save(codes_path + ".part.npy", codes)
    os.replace(codes_path + ".part.npy", codes_path)
    return codes, ref


class Setup:
    """The reference, the index and the workers of one configuration."""

    def __init__(self, cell, device, rehearse: bool, options=None):
        import torch

        cfg = cell.config
        self.cell = cell
        self.device = device
        self.rehearse = rehearse
        self.phases = {}
        t = clock()
        n = (REHEARSAL["genome_length"] if rehearse
             else int(cfg["genome_length"]))
        self.contig = cfg["genome"]["contig"]
        self.codes, ref = reference_genome(cfg["genome"], n)
        t = self._phase("genome", t)
        self.options = dict(cfg["mem_options"], K=cfg["chunk_bases"],
                            **(options or {}))
        if rehearse:
            self.options["K"] = REHEARSAL["K"]
        self.opt = program.make_opt(self.options)
        self.chunk = program.chunk_bases(self.options, self.opt)
        self.idx = program.load_index(ref)
        t = self._phase("load_index", t)
        self.workers = program.Workers(
            self.idx, self.opt, program.n_workers(self.options), device,
            cfg["positions"] == "int64")
        self.aligners = self.workers.aligners
        self._phase("workers", t)
        self.tmp = tempfile.mkdtemp(prefix="portbench-")
        self.torch = torch

    def _phase(self, name: str, t0: float) -> float:
        t = clock()
        self.phases[name] = t - t0
        return t

    def pool(self, seed: int):
        """The seed's FASTQ pool: (pairs, plan, first pair and pairs of
        each chunk)."""
        tr = self.cell.traffic
        L = int(tr["read_len"])
        per = pairs_per_chunk(self.chunk, L)
        n_pool = REHEARSAL["pool_chunks"] if self.rehearse \
            else int(tr["pool_chunks"])
        pairs = simulate_pairs(self.codes, n_pool * per, seed_entropy(seed),
                               tr)
        paths = [os.path.join(self.tmp, f"r{m}.fq") for m in (1, 2)]
        for path, reads in zip(paths, (pairs.r1, pairs.r2)):
            with open(path, "wb") as fh:
                fh.write(fastq_bytes(reads, 0))
        plan_ = program.plan(paths[0], paths[1], self.chunk)
        counts = [c.count for c in plan_.chunks]
        if counts != [per] * n_pool:
            raise RuntimeError(f"chunks of {counts} pairs, not {n_pool} of "
                               f"{per}")
        first = np.array([c.start for c in plan_.chunks], np.int64)
        return pairs, plan_, first, np.array(counts, np.int64)

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def anchor(self) -> "tuple[float, float]":
        """Mark the device timeline: a spin kernel right after a
        synchronize; returns the host clock and the epoch time at its
        launch."""
        self.sync()
        t, epoch = clock(), time.time()
        self.torch.cuda._sleep(20_000)
        self.sync()
        return t, epoch

    def window(self, aligners, seed: int, seconds: float,
               traced: bool = False, warm: bool = True):
        """Warm-up (one chunk a worker) and window over the seed's pool:
        (Window, Sink, pairs, counter deltas, trace summary or None, the
        clock when set-up ended)."""
        t = clock()
        pairs, plan_, first, pairs_in = self.pool(seed)
        t = self._phase("pool", t)
        tr = self.cell.traffic
        n_pool = len(pairs_in)
        nw = len(aligners)
        n_sample = (REHEARSAL["sample_pairs"] if self.rehearse
                    else int(tr["sample_pairs"]))

        spans: list = []
        span_log = None

        def chunk_fn(al, ci):
            return program.run_chunk(al, plan_, ci, clock, span_log)

        if warm:
            run_window(chunk_fn, aligners, n_pool, float("inf"),
                       Sink(first, pairs_in, seed_entropy(seed), 0),
                       pairs_in, max_rounds=1)
        self.sync()
        t_ready = self._phase("warm_up", t)
        print("[portbench] set-up seconds: " + ", ".join(
            f"{k} {v:.2f}" for k, v in self.phases.items()),
            file=sys.stderr, flush=True)
        c0 = program.counters(aligners)
        sink = Sink(first, pairs_in, seed_entropy(seed),
                    -(-n_sample // nw))
        if traced:
            from torch.profiler import ProfilerActivity, profile

            span_log = spans
            program.wrap_spans(aligners, spans, clock)
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            time.sleep(T.MARGIN_S)  # the anchor well inside the capture
            a0 = self.anchor()
        win = run_window(chunk_fn, aligners, n_pool, seconds, sink, pairs_in,
                         first=nw)
        summary = None
        if traced:
            a1 = self.anchor()
            time.sleep(T.MARGIN_S)
            prof.stop()
            events = T.device_events(prof)
            summary = T.reduce(events, (a0[0], a1[0]), spans,
                               program.kernel_names())
            if summary:
                summary["anchor_lag_ms"] = T.anchor_lags(
                    events, (a0[1], a1[1]))
            print(f"[portbench] trace: {len(events)} device events, "
                  f"{sum(T.ANCHOR in e[0] for e in events)} anchors, lag ms "
                  f"{summary and summary['anchor_lag_ms']}",
                  file=sys.stderr, flush=True)
            del prof
        self.sync()
        c1 = program.counters(aligners)
        deltas = {k: c1[k] - c0[k] for k in c0}
        return win, sink, pairs, deltas, summary, t_ready

    def check(self, sink, pairs, n_sample: int) -> dict:
        tr = self.cell.traffic
        nums = reference.check_pairs(
            sink.sample(n_sample), pairs, self.codes,
            self.cell.config["scoring"], self.contig, tr["insert_mean"],
            tr["insert_sd"])
        nums["missing_records"] = sink.missing
        return nums

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


def limits_of(cell) -> dict:
    return cell.traffic["limits"]


def judge(nums: dict, limits: dict) -> "tuple[bool, dict]":
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def loaded_jax() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(JAX_NAMES))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def measure(cell, seed: int, seconds: float, traced: bool, rehearse: bool,
            t_proc: float, options=None, device=None
            ) -> "tuple[dict | None, list]":
    """One run of a cell: (the result line's object, the checks' lines for
    standard error). The object is None when the run may not report. A
    rehearsal runs at the tiny sizes, on the CPU unless device says, and
    reports no metric."""
    import torch

    from .spec import read_metrics

    if device is None:
        device = torch.device("cpu" if rehearse else "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    s = Setup(cell, device, rehearse, options)
    try:
        win, sink, pairs, deltas, summary, t_ready = s.window(
            s.aligners, seed, seconds, traced)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        found = loaded_jax()
        if found:
            return None, [f"loaded after the window: {', '.join(found)}"]
        s.workers = s.aligners = s.idx = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        n_sample = (REHEARSAL["sample_pairs"] if rehearse
                    else int(cell.traffic["sample_pairs"]))
        nums = s.check(sink, pairs, n_sample)
    finally:
        s.close()
    correct, checks = judge(nums, limits_of(cell))
    anchored = summary if summary and summary["anchors"] else None
    # what the run measured, as the metric readers see it: device metrics
    # only from a window that an anchor maps
    run = types.SimpleNamespace(
        reads=win.reads, attempted=win.attempted, window_s=win.seconds,
        setup_s=t_ready - t_proc, peak_bytes=peak, parse_s=win.parse_s,
        program=deltas, trace=anchored, chunks=win.chunks)
    print(f"[portbench] window: {win.chunks} chunks, {win.seconds:.3f} s, "
          f"tail idle {win.tail_idle_pct:.3f}% of worker time",
          file=sys.stderr, flush=True)
    lines = [f"check {k}: {c['value']} (limit {c['limit']})"
             for k, c in checks.items()]
    out = {"correct": correct, "attempted": win.attempted,
           "failed": int(nums["missing_records"])}
    if rehearse:
        out["metrics"] = {}
        out["rehearsal"] = {"reads": win.reads, "chunks": win.chunks}
    else:
        entries = cell.per_layer if traced else cell.end_to_end
        out["metrics"] = read_metrics(entries, run)
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": cell.chips, "memory_peak_bytes": peak}
        if traced:
            busy = summary["busy_s"] if summary else 0.0
            out["device"]["busy_s"] = busy
            out["device"]["window_s"] = (summary["window_s"] if summary
                                         else win.seconds)
            if summary:
                out["breakdown"] = {"device_ops": summary["device_ops"],
                                    "idle_gaps": summary["idle_gaps"]}
            out["trace"] = {
                "anchors": summary["anchors"] if summary else 0,
                "anchor_lag_ms": summary["anchor_lag_ms"] if summary
                else []}
        out["window"] = {"chunks": win.chunks, "seconds": win.seconds,
                         "tail_idle_pct": win.tail_idle_pct,
                         "cpu_s": win.cpu_s}
        out["card"] = card()
    out["checks"] = checks
    return out, lines
