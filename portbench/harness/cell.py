"""One cell's run: set-up, the measured window, the numbers, the check.

Set-up makes the reference from the configuration's genome seed (and on
a checkout's first run writes it and builds its index under
build/portbench/), loads the index, builds the workers, has the mix's
generator (generators/<name>.py) write the seed's FASTQ pool into TMPDIR,
plans its chunks as `cli mem` does and warms the workers up with one chunk
each. The window then cycles through the pool (window.py). Once it has
closed, the peak memory is read, the program's state freed, and the mix's
check (checks/<name>.py, by the rules of reference.py) judges a sample of
the records.
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
from . import trace as T
from .spec import ROOT, mix_module
from .window import Sink, clock, run_window

JAX_NAMES = ("jax", "jaxlib", "flax", "mpibwa_tpu")
# the CPU rehearsal's sizes: a small genome, small chunks, a short pool,
# the sample in units (pairs or reads)
REHEARSAL = {"genome_length": 2_000_000, "K": 100_000, "pool_chunks": 6,
             "sample": 300}


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
        self.generator = mix_module(cell.traffic, "generator")
        self.checker = mix_module(cell.traffic, "check")
        self.options = dict(cfg["mem_options"], K=cfg["chunk_bases"],
                            **(options or {}))
        if rehearse:
            self.options["K"] = REHEARSAL["K"]
        self.opt = program.make_opt(self.options, self.generator.PAIRED)
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
        """The seed's pool (simulate.Pool) and the program's plan of it,
        which has to be the generator's."""
        n_pool = REHEARSAL["pool_chunks"] if self.rehearse \
            else int(self.cell.traffic["pool_chunks"])
        pool = self.generator.pool(self.codes, seed_entropy(seed),
                                   self.cell.traffic, self.chunk, n_pool,
                                   self.tmp)
        plan_ = program.plan(pool.paths, self.chunk, self.opt)
        got = [(c.start, c.count) for c in plan_.chunks]
        want = list(zip(pool.first.tolist(), pool.units.tolist()))
        if got != want or plan_.is_pe != self.generator.PAIRED:
            raise RuntimeError(f"the program planned chunks {got[:3]}... "
                               f"(paired {plan_.is_pe}), the generator "
                               f"{want[:3]}... of {n_pool}")
        return pool, plan_

    def sample_size(self) -> int:
        """Units the check judges: the rehearsal's, or the mix's."""
        return (REHEARSAL["sample"] if self.rehearse
                else int(self.cell.traffic[self.generator.SAMPLE]))

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
        (Window, Sink, pool, counter deltas, trace summary or None, the
        clock when set-up ended)."""
        t = clock()
        pool, plan_ = self.pool(seed)
        t = self._phase("pool", t)
        n_pool = len(pool.units)
        nw = len(aligners)
        n_sample = self.sample_size()

        spans: list = []
        span_log = None

        def chunk_fn(al, ci):
            return program.run_chunk(al, plan_, ci, clock, span_log,
                                     pool.n_processed[ci])

        if warm:
            run_window(chunk_fn, aligners, n_pool, float("inf"),
                       Sink(pool, seed_entropy(seed), 0), max_rounds=1)
        self.sync()
        t_ready = self._phase("warm_up", t)
        print("[portbench] set-up seconds: " + ", ".join(
            f"{k} {v:.2f}" for k, v in self.phases.items()),
            file=sys.stderr, flush=True)
        c0 = program.counters(aligners)
        sink = Sink(pool, seed_entropy(seed), -(-n_sample // nw))
        if traced:
            from torch.profiler import ProfilerActivity, profile

            span_log = spans
            program.wrap_spans(aligners, spans, clock)
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            time.sleep(T.MARGIN_S)  # the anchor well inside the capture
            a0 = self.anchor()
        win = run_window(chunk_fn, aligners, n_pool, seconds, sink, first=nw)
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
        return win, sink, pool, deltas, summary, t_ready

    def check(self, sink, pool) -> dict:
        """The mix's check of a sample of the kept records, and the reads
        whose record was missing."""
        nums = self.checker.check(
            sink.sample(self.sample_size()), pool.truth, self.codes,
            self.contig, self.cell.config["scoring"], self.cell.traffic)
        nums["missing_records"] = sink.missing
        return nums

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


def limits_of(cell) -> dict:
    return cell.traffic["limits"]


def judge(nums: dict, limits: dict) -> "tuple[bool, dict]":
    unknown = sorted(set(limits) - set(nums))
    if unknown:
        raise KeyError(f"limits name numbers the check did not compute: "
                       f"{', '.join(unknown)}")
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
        win, sink, pool, deltas, summary, t_ready = s.window(
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
        nums = s.check(sink, pool)
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
