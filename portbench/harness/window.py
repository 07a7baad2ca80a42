"""The measured window: workers take whole chunks round-robin, as
``Runtime._execute`` assigns them, and cycle through the pool of chunks.

No chunk starts once ``seconds`` have passed since the window opened; the
window closes when the last started chunk's records are out. The rate is
every read whose record came out over the time from the first chunk
handed in to the last record out. The process's CPU seconds (all its
threads) over the same span are what that work cost the host.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time

import numpy as np

clock = time.perf_counter
cpu_clock = time.process_time  # the process's CPU seconds, all threads


@dataclasses.dataclass
class Window:
    reads: int  # reads whose records came out
    attempted: int  # reads handed in
    chunks: int
    start: float  # clock() when the first chunk was handed in
    end: float  # clock() when the last record was out
    parse_s: float  # seconds in FASTQ parsing, summed over workers
    worker_ends: list  # clock() when each worker's last record was out
    cpu_s: float = 0.0  # the process's CPU seconds from start to end

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def rate(self) -> float:
        return self.reads / self.seconds

    @property
    def tail_idle_pct(self) -> float:
        """Worker-seconds idle after each worker's last chunk, as a share
        of all the workers' time in the window: what closing on whole
        chunks costs the rate."""
        idle = sum(self.end - max(e, self.start) for e in self.worker_ends)
        return 100.0 * idle / (len(self.worker_ends) * self.seconds)


def worker_chunks(wi: int, nw: int, n_pool: int, first: int = 0):
    """(run index, pool chunk) of worker wi's runs: round-robin over the
    cycled pool, from the pool's chunk `first`."""
    k = wi
    while True:
        yield k, (first + k) % n_pool
        k += nw


class Sink:
    """Takes each chunk run's records, one a read (a read's record holds
    its primary line and any supplementary ones): counts the reads whose
    record is missing or names another read, and keeps the sampled units'
    text.

    pool (simulate.Pool) lays out the chunks: each chunk's first unit and
    units, the reads a unit and each unit's QNAME; a chunk run k keeps
    per_run units drawn from (seed, k)."""

    def __init__(self, pool, seed: int, per_run: int):
        self.first = pool.first
        self.units = pool.units
        self.per_unit = pool.per_unit
        self.name = pool.name
        self.reads = pool.reads
        self.seed = seed
        self.per_run = per_run
        self.lock = threading.Lock()
        self.missing = 0
        self.samples: list = []  # (run, unit index, each read's text)

    def put(self, run: int, ci: int, records) -> int:
        """Takes a chunk run's records; returns the reads left without
        theirs."""
        u0 = int(self.first[ci])
        n = int(self.units[ci])
        per = self.per_unit
        missing = 0
        for i, rec in enumerate(records):
            if not rec.startswith(self.name(u0 + i // per) + b"\t"):
                missing += 1
        missing += max(0, int(self.reads[ci]) - len(records))
        rng = np.random.default_rng([self.seed, run])
        pick = rng.choice(n, min(self.per_run, n), replace=False)
        kept = [(run, u0 + int(j),
                 *(records[per * j + m].decode()
                   if per * j + m < len(records) else ""
                   for m in range(per)))
                for j in pick]
        with self.lock:
            self.missing += missing
            self.samples.extend(kept)
        return missing

    def sample(self, n: int) -> list:
        """n of the kept units, drawn from the seed: (unit, each read's
        text)."""
        kept = sorted(self.samples)
        rng = np.random.default_rng([self.seed, 1 << 40])
        pick = rng.choice(len(kept), min(n, len(kept)), replace=False)
        return [kept[i][1:] for i in sorted(pick)]


def run_window(run_chunk, workers, n_pool: int, seconds: float, sink,
               first: int = 0, max_rounds: "int | None" = None) -> Window:
    """Run the window with one thread a worker. run_chunk(worker, chunk)
    returns (records, parse seconds); a chunk's reads are the sink's; with
    max_rounds each worker stops after that many chunks (the warm-up)."""
    nw = len(workers)
    lock = threading.Lock()
    tot = {"reads": 0, "attempted": 0, "chunks": 0, "parse": 0.0,
           "end": 0.0}
    ends = [0.0] * nw
    c_start = cpu_clock()
    t_start = clock()
    t_stop = t_start + seconds

    def work(wi):
        for k, ci in worker_chunks(wi, nw, n_pool, first):
            if clock() >= t_stop or (max_rounds is not None
                                     and k >= max_rounds * nw):
                return
            with lock:
                tot["attempted"] += int(sink.reads[ci])
            records, parse = run_chunk(workers[wi], ci)
            missing = sink.put(k, ci, records)
            t = clock()
            with lock:
                tot["reads"] += int(sink.reads[ci]) - missing
                tot["chunks"] += 1
                tot["parse"] += parse
                tot["end"] = max(tot["end"], t)
                ends[wi] = t

    with concurrent.futures.ThreadPoolExecutor(max_workers=nw) as ex:
        for fu in [ex.submit(work, wi) for wi in range(nw)]:
            fu.result()
    return Window(tot["reads"], tot["attempted"], tot["chunks"], t_start,
                  tot["end"], tot["parse"], ends, cpu_clock() - c_start)
