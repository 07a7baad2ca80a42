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

from .simulate import pair_name

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
    """Takes each chunk run's records: counts the reads whose record is
    missing or names another read, and keeps the sampled pairs' text.

    first_pair[ci] is the pool index of chunk ci's first pair; a chunk run
    k keeps per_run pairs drawn from (seed, k)."""

    def __init__(self, first_pair, pairs_in, seed: int, per_run: int):
        self.first_pair = first_pair
        self.pairs_in = pairs_in
        self.seed = seed
        self.per_run = per_run
        self.lock = threading.Lock()
        self.missing = 0
        self.samples: list = []  # (run, pair index, R1 text, R2 text)

    def put(self, run: int, ci: int, records) -> int:
        """Takes a chunk run's records; returns the reads left without
        theirs."""
        p0 = int(self.first_pair[ci])
        n = int(self.pairs_in[ci])
        missing = 0
        for i, rec in enumerate(records):
            if not rec.startswith(pair_name(p0 + (i >> 1)) + b"\t"):
                missing += 1
        missing += max(0, 2 * n - len(records))
        rng = np.random.default_rng([self.seed, run])
        pick = rng.choice(n, min(self.per_run, n), replace=False)
        kept = [(run, p0 + int(j),
                 records[2 * j].decode() if 2 * j < len(records) else "",
                 records[2 * j + 1].decode()
                 if 2 * j + 1 < len(records) else "")
                for j in pick]
        with self.lock:
            self.missing += missing
            self.samples.extend(kept)
        return missing

    def sample(self, n: int) -> list:
        """n of the kept pairs, drawn from the seed: (pair, R1, R2)."""
        kept = sorted(self.samples)
        rng = np.random.default_rng([self.seed, 1 << 40])
        pick = rng.choice(len(kept), min(n, len(kept)), replace=False)
        return [kept[i][1:] for i in sorted(pick)]


def run_window(run_chunk, workers, n_pool: int, seconds: float, sink,
               pairs_in, first: int = 0, max_rounds: "int | None" = None
               ) -> Window:
    """Run the window with one thread a worker. run_chunk(worker, chunk)
    returns (records, parse seconds); with max_rounds each worker stops
    after that many chunks (the warm-up)."""
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
                tot["attempted"] += 2 * int(pairs_in[ci])
            records, parse = run_chunk(workers[wi], ci)
            missing = sink.put(k, ci, records)
            t = clock()
            with lock:
                tot["reads"] += 2 * int(pairs_in[ci]) - missing
                tot["chunks"] += 1
                tot["parse"] += parse
                tot["end"] = max(tot["end"], t)
                ends[wi] = t

    with concurrent.futures.ThreadPoolExecutor(max_workers=nw) as ex:
        for fu in [ex.submit(work, wi) for wi in range(nw)]:
            fu.result()
    return Window(tot["reads"], tot["attempted"], tot["chunks"], t_start,
                  tot["end"], tot["parse"], ends, cpu_clock() - c_start)
