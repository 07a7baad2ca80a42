#!/usr/bin/env python3
"""Drive the torch port's main path once on one NVIDIA GPU and check it.

Phases, one printed line (or more) each:
  1. the card's name and power limit (nvidia-smi);
  2. the three CUDA kernels (mpibwa_tpu_torch/csrc/extend.cu,
     occ4_extend.cu, bwd_pass.cu) built from the checkout, one nvcc each,
     all started together; then kernel 1 held against the plain PyTorch
     version (exact equality) on random problems at every window bucket
     and on the edge cases of tests/_torch_toy.extend_edge_cases, timed
     (median of 5 CUDA-event timings after a warm-up); later (2b) the same
     on the two largest calls captured from phase 4, where the plain
     version is timed too and the DP cells the problems visit are counted;
  3. a synthetic genome the length of GRCh38 chr1 (248,956,422 bp) with
     N holes and planted repeats, indexed with index/build.py and cached
     under build/genome/ by seed and size;
  4. `mpibwa_tpu_torch.cli mem -t 1` with MPIBWA_EXT=device on simulated
     101-bp pairs, the default backward engine otherwise (each backward
     pass one launch of the pass kernel): kernels 1 and 2 (launch counts
     reset just before);
  5. the same run with MPIBWA_EXT=native (every DP in C): the SAM must be
     byte-identical to phase 4's;
  6. the first pairs through the host spec engine (core/,
     Runtime(use_device=False)): byte-identical to the port's SAM on the
     same file;
  7. phases 4 and 6 for SE reads (R1);
  8. phase 4's run with MPIBWA_BWD=flat MPIBWA_PALLAS=1 (the flat backward
     engine, every round extending through the fused occ4 kernel): SAM
     byte-identical to phase 4's;
  9. phase 4's run with MPIBWA_BWD=flat, MPIBWA_BWD=contig, the default,
     MPIBWA_BWD=v8 and the default again, in turns after phase 8: every
     SAM byte-identical to phase 4's; reads/s and the backward stages of
     each, whether the default is slower than flat against both of its
     neighbours, whether contig beats both of its neighbours (flat and
     the default) and whether v8 beats the default against both of its
     neighbours;
  11. the v8 turn of phase 9 (PE, MPIBWA_EXT=device, phase 4's input):
     its SAM byte-identical to phase 4's, its stages (fwd1, bwd1, pass2
     with p2_fwd and p2_bwd), host reads of the backward, pass-2 runs on
     the speculative route and redone, v8 passes redone on the flat engine
     and peak device memory;
  10. the default run and phase 8's once more on the first --traced-pairs
     pairs (5,000) under torch.profiler (CUDA activity only): each
     kernel's own device time summed over the run ("run_ms", over
     "run_pairs" pairs) and the card's busy share of the align time;
  2c. the occ4 kernel against the plain version (exact equality) on seeded
     intervals over the index, both directions, E in {1,000, 65,536,
     1,048,576}, on the largest batch captured from phase 8 and on
     tests/_torch_toy.occ4_edge_intervals; timed beside the plain version
     and the O2 `extend` (medians of 5, CUDA events);
  2d. the pass kernel against the plain pass over the entry state captured
     from phase 4's first backward call (all seven state arrays, the round
     count and the emitted mems equal) and over the edge lanes of
     tests/_torch_toy.bwd_edge_lanes at every register instance, with
     their query rows as they are and padded to 16,384 bp (past 12,288 bp
     the kernel reads each row in place, Lp = 0); a whole pass timed
     (median of 5 after a warm-up) and its bound over the pass;
  2e. the int64 position path: the phase 3 index loaded again with
     force_wide=True, collect_flat on the first 16,384 reads of phase 4's
     input under v8 (== v8 on the int32 index in all three arrays), under
     flat and under contig (each == v8 on (x0, x2, info), the offsets and
     the fallback flags), v8, flat and contig on it timed in turns
     (medians of 3 after a warm-up) with peak device memory and the
     kernels' launches;
  2f. the default's pass-1 backward of phase 4's first microbatch
     (DeviceSeeder._backward_rows, captured) replayed and timed in its
     parts (lane tables and entries, entry state, pass kernel, the rows'
     compaction and pull) beside the per-lane-list route it replaces
     (medians of 5, a synchronize around each part);
  12. the record route (the route without the C runtime's chain and
     finalization: MPIBWA_FINAL=python MPIBWA_CHAIN=python) on phase 6's
     pairs, PE and SE: SAM byte-identical to phases 6 and 7's port runs on
     the same files, kernels 1 and 2 launched, the global DP
     (ops/global_batch.py) and the rescue SW (ops/rescue.py) on CUDA
     tensors; reads/s, stage seconds, problem counts and the CUDA-event
     time around those calls, summed;
  13. `cli launch -n 2 --hosts localhost,localhost mem` on phase 6's pairs
     with a -K that gives both shards chunks: the merged SAM equals the
     single-process run's at the same -K (@PG lines aside); both wall
     times;
  14a. --long-reads (20) ONT-like SE reads of 700-2,500 bp off the genome
     (tests/_torch_toy.long_reads, no N) under -x ont2d, 14b. as many FR
     pairs of 400-700 bp reads (insert N(1,500, 150)) with bwa's defaults:
     each SAM byte-identical to the host spec engine's; the share of reads
     the device seeder hands to the host engine, reads/s, seconds a read;
  14c. phase 7's first 16,383 SE reads and, last, a 66,000-bp read off the
     genome (0.1% substitutions, no N), MPIBWA_EXT=device: the int64 call
     words, every pass launch reading its query row in place, kernels 1
     and 2 launched; the short reads' lines equal a run on them alone, the
     wide read's the host spec engine's; fwd1 and its steps, the stages,
     launches and peak device memory.
Phases 4, 8 and 9 print each kernel's launches by batch size; every
default-chaining run (phases 4-11, 14) must have chained in C.
Every launch count is set to 0 just before a run of the main path and read
just after. Each kernel's bound is the larger of the bytes its inputs need
(each byte once, a block row once however many entries read it) over
3.35 TB/s and its integer operations over 33.5 TOP/s (int32 runs on
half the lanes of the card's 67 TFLOP/s float32 rate). Then a JSON line of
kernel results, and last
{"ok": true, "device": {"platform": "gpu", ...}}.

Usage: python3 chip_smoke.py [--pairs N] [--host-pairs N] [--genome-bp N]
                             [--seed S] [--traced-pairs N] [--long-reads N]
(--host-pairs sets the pairs of phases 6, 7, 12 and 13.)
Exits non-zero without a usable CUDA device, on any mismatch and on any
error.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = {
    "extend": {"name": "extend_batch", "route": "cuda",
               "source": "mpibwa_tpu_torch/csrc/extend.cu",
               "replaces": "mpibwa_tpu/ops/pallas_extend.py:248"},
    "occ4_extend": {"name": "occ4_extend", "route": "cuda",
                    "source": "mpibwa_tpu_torch/csrc/occ4_extend.cu",
                    "replaces": "mpibwa_tpu/ops/pallas_occ4.py:107"},
    "bwd_pass": {"name": "bwd_pass", "route": "cuda",
                 "source": "mpibwa_tpu_torch/csrc/bwd_pass.cu",
                 "replaces": "mpibwa_tpu/ops/pallas_bwd.py:242"},
}
# each kernel's name in a profiler trace (csrc/*.cu)
SYMBOLS = {"extend": "extend_kernel<", "occ4_extend": "occ4_extend_kernel",
           "bwd_pass": "bwd_pass_kernel<"}
# the earlier round kernel (one launch a round) at phase 2d's captured
# shape, from PERF.md (H100 80GB HBM3, 700 W): the old design's yardstick
OLD_PASS_MS, OLD_LAUNCH_MS = 2.8365, 0.0423
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_OPS_PER_S = 33.5e12  # half the lanes of its 67 TFLOP/s float32 rate
# integer operations of one bwt_extend in the block kernels: two occ4 of
# about 10 + 20 a counted word (4.5 words at a uniform offset) and about 60
# of interval arithmetic and selects
OPS_PER_EXTENSION = 2 * (10 + 20 * 4.5) + 60
OPS_PER_DP_CELL = 16  # adds, maxima and selects of one ksw_extend2 cell
# every Q and T bucket of DeviceAligner.Q_BUCKETS / T_BUCKETS
BUCKETS = [(64, 128), (128, 256), (192, 384), (256, 512), (512, 768),
           (512, 1024)]
PEN = (6, 1, 6, 1)  # bwa-mem's default gap open/extend, del and ins


class Failed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 2: the kernel against its plain version ---------------------------

def random_problems(rng, B, Q, T, dev):
    """B extension problems in a (Q, T) window: targets share a prefix with
    the query at 5% substitutions (some N), random lengths and params."""
    q = rng.integers(0, 4, (B, Q), dtype=np.uint8)
    t = rng.integers(0, 4, (B, T), dtype=np.uint8)
    n = min(Q, T)
    t[:, :n] = q[:, :n]
    mut = rng.random((B, T)) < 0.05
    t[mut] = rng.integers(0, 5, int(mut.sum()), dtype=np.uint8)
    ql = rng.integers(1, Q + 1, B).astype(np.int32)
    tl = rng.integers(0, T + 1, B).astype(np.int32)
    q[np.arange(Q)[None, :] >= ql[:, None]] = 4
    t[np.arange(T)[None, :] >= tl[:, None]] = 4
    par = np.stack([rng.integers(1, 120, B), rng.choice([0, 5], B),
                    rng.choice([0, 100], B), rng.integers(1, 80, B)],
                   axis=1).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (q, t, ql, tl, par)]


def max_err(got, want) -> int:
    if isinstance(got, tuple):
        got, want = torch.stack(list(got)), torch.stack(list(want))
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def extend_err(args, pen) -> int:
    """The kernel's max abs difference from the plain version over the six
    outputs (0 = exact)."""
    from mpibwa_tpu_torch.ops.extend_batch import extend_batch
    from mpibwa_tpu_torch.ops.extend_cuda import extend_batch_kernel

    got = extend_batch_kernel(*args, *pen)
    torch.cuda.synchronize()
    return max_err(got, extend_batch(*args, *pen))


def median_ms(fn, reps: int) -> float:
    fn()  # warm-up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def extend_ms(args, pen, reps: int) -> float:
    from mpibwa_tpu_torch.ops.extend_cuda import extend_batch_kernel

    return median_ms(lambda: extend_batch_kernel(*args, *pen), reps)


def bound(nbytes: float, ops: float) -> "tuple[float, str]":
    """(least ms the card could take, which side sets it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def extend_bound(args) -> "tuple[float, str, int]":
    """Bound of one extension call: the DP cells these problems visit
    (counted in the plain version) as integer operations, against the bytes
    of the windows, lengths, params, matrix and outputs, each once."""
    from mpibwa_tpu_torch.ops.extend_batch import extend_batch

    stats = {}
    extend_batch(*args, *PEN, stats=stats)
    cells = int(stats["cells"])
    qs, ts, qlens, tlens, params, _ = args
    B = qs.shape[0]
    nbytes = (qs.numel() + ts.numel() + 4 * (qlens.numel() + tlens.numel()
                                             + params.numel() + 25)
              + 6 * B * 4)
    return bound(nbytes, cells * OPS_PER_DP_CELL) + (cells,)


def phase2_random(rng, dev, mat, toy) -> int:
    """Kernel 1 against the plain version on random problems at every
    bucket and on the edge cases; returns the worst difference."""
    from mpibwa_tpu_torch.ops import _build

    t0 = time.time()
    names = list(KERNELS)
    _build.load_all(names)
    log(f"phase 2 build: nvcc sm_90a, {len(names)} sources side by side, "
        f"{time.time() - t0:.2f}s")
    for name in names:
        # each instance's entry (mangled: ILi4E = the template argument 4),
        # then its registers and spills
        regs = [ln.strip()
                for ln in _build.build_logs.get(name, "").splitlines()
                if "registers" in ln or "spill" in ln
                or "Compiling entry" in ln]
        log(f"phase 2 build {name}: "
            + ("; ".join(regs) or "library already built under build/kernels"))
    worst = 0
    for (Q, T), B in [(b, 4096) for b in BUCKETS] + [((128, 256), 65536)]:
        args = random_problems(rng, B, Q, T, dev) + [mat]
        err = extend_err(args, PEN)
        ms = extend_ms(args, PEN, 5)
        log(f"phase 2 random problems Q={Q} T={T} B={B}: max_abs_err="
            f"{err}; kernel {ms:.4f} ms (median of 5 after a warm-up, CUDA "
            f"events)")
        worst = max(worst, err)
    for c in toy.extend_edge_cases(int(rng.integers(1 << 30))):
        args = [torch.from_numpy(c[k]).to(dev) for k in
                ("q", "t", "qlens", "tlens", "params", "mat")]
        err = extend_err(args, c["pen"])
        ms = extend_ms(args, c["pen"], 5)
        B, Q = c["q"].shape
        log(f"phase 2 edge case {c['name']} (B={B}, Q={Q}, "
            f"T={c['t'].shape[1]}): max_abs_err={err}; kernel {ms:.4f} ms")
        worst = max(worst, err)
    if worst:
        raise Failed("kernel 1 disagrees with the plain version")
    return worst


# -- phase 3: the genome -------------------------------------------------------

def make_chr1(seed: int, n: int) -> np.ndarray:
    """ASCII bases of a synthetic chromosome: uniform random sequence with
    planted repeat families (per chr1 length: 4000 300-bp units at 10%
    divergence, 200 6-kbp units at 2%, 50 exact 600-bp copies) and N holes
    (10 kbp at both ends, 30 gaps of 20-100 kbp), scaled to length n."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    scale = n / 248_956_422
    for unit_len, copies, div in ((300, 4000, 0.10), (6000, 200, 0.02),
                                  (600, 50, 0.0)):
        unit = rng.integers(0, 4, unit_len, dtype=np.uint8)
        for pos in rng.integers(10_000, n - 10_000 - unit_len,
                                max(2, int(copies * scale))):
            c = unit.copy()
            hit = rng.random(unit_len) < div
            c[hit] = rng.integers(0, 4, int(hit.sum()), dtype=np.uint8)
            codes[pos: pos + unit_len] = c
    ascii_ = np.frombuffer(b"ACGT", np.uint8)[codes]
    ascii_[:10_000] = ord("N")
    ascii_[n - 10_000:] = ord("N")
    for pos in rng.integers(10_000, n - 110_000, max(1, int(30 * scale))):
        ascii_[pos: pos + int(rng.integers(20_000, 100_000))] = ord("N")
    return ascii_


def build_genome(seed: int, n: int) -> "tuple[str, str]":
    """(index prefix, sequence): FASTA + bwa index under build/genome/."""
    from mpibwa_tpu_torch.index.build import build_index

    d = os.path.join(REPO, "build", "genome", f"chr1-{n}-seed{seed}")
    ref = os.path.join(d, "chr1.fa")
    seq = make_chr1(seed, n)
    if not os.path.exists(ref + ".done"):
        os.makedirs(d, exist_ok=True)
        with open(ref, "wb") as fh:
            fh.write(b">chr1 synthetic\n")
            full = n // 60 * 60
            lines = np.empty((n // 60, 61), np.uint8)
            lines[:, :60] = seq[:full].reshape(-1, 60)
            lines[:, 60] = ord("\n")
            fh.write(lines.tobytes())
            if full < n:
                fh.write(seq[full:].tobytes() + b"\n")
        build_index(ref)
        open(ref + ".done", "w").close()
    return ref, seq.tobytes().decode("ascii")


# -- phases 4-7: the CLI --------------------------------------------------------

class Spy:
    """Records the Runtime the CLI builds, a few extension kernel calls (the
    largest B) for phase 2b, the largest occ4 batch for phase 2c, the first
    backward pass through the pass kernel for phase 2d and the batch size
    of every wrapper call that launches a kernel. The launch counts stay on
    the wrappers themselves."""

    def __init__(self):
        from mpibwa_tpu_torch.ops import bwd_cuda, extend_cuda, occ4_cuda
        from mpibwa_tpu_torch.parallel.runtime import Runtime
        from mpibwa_tpu_torch.pipeline import device_seed
        from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

        self.runtimes = []
        self.captured = []
        self.occ4_ik = None
        self.bwd_call = None
        self.rows_call = None
        self.sizes = {name: [] for name in KERNELS}
        self.pass_widths = []  # query-row width of every pass launch
        self.word_dtypes = []  # dtype of every pass-1 call-word tensor
        self._lock = threading.Lock()
        self._mods = (extend_cuda, occ4_cuda, bwd_cuda)
        self._real = extend_cuda.extend_batch_kernel
        self._real_occ4 = occ4_cuda.extend_kernel
        self._real_bwd = bwd_cuda.run_backward_fused
        self._real_pass = bwd_cuda.bwd_pass_kernel
        self._real_rows = DeviceSeeder._backward_rows
        self._real_words = device_seed.pack_call_words
        self.wrappers = self.kernel_wrappers()
        self._rt_init = Runtime.__init__
        spy = self

        def rt_init(rt, *a, **k):
            spy._rt_init(rt, *a, **k)
            spy.runtimes.append(rt)

        def sized(name, real, size, *a):
            """real(*a), its batch size kept if it launched."""
            n0 = spy.wrappers[name].launches
            out = real(*a)
            if spy.wrappers[name].launches != n0:
                with spy._lock:
                    spy.sizes[name].append(size)
            return out

        def capture(qs, ts, qlens, tlens, params, mat, *pen):
            out = sized("extend", spy._real, qs.shape[0], qs, ts, qlens,
                        tlens, params, mat, *pen)
            with spy._lock:
                spy.captured.append(
                    [x.clone() for x in (qs, ts, qlens, tlens, params)]
                    + [mat])
                spy.captured.sort(key=lambda c: -c[0].shape[0])
                del spy.captured[2:]
            return out

        def capture_occ4(fm, ik, is_back):
            out = sized("occ4_extend", spy._real_occ4, ik.shape[0], fm, ik,
                        is_back)
            with spy._lock:
                if is_back and (spy.occ4_ik is None
                                or ik.shape[0] > spy.occ4_ik.shape[0]):
                    spy.occ4_ik = ik.clone()
            return out

        def capture_bwd(fm, qrows, entry, n_lanes, x0, minv, lane_off, **k):
            with spy._lock:
                if spy.bwd_call is None:
                    spy.bwd_call = (qrows.clone(),
                                    tuple(t.clone() for t in entry),
                                    np.array(x0), np.array(minv),
                                    np.array(lane_off))
            return spy._real_bwd(fm, qrows, entry, n_lanes, x0, minv,
                                 lane_off, **k)

        def capture_rows(seeder, qd, call_list, ivals, infos):
            with spy._lock:
                if spy.rows_call is None:
                    spy.rows_call = (seeder, qd, np.array(call_list), ivals,
                                     infos)
            return spy._real_rows(seeder, qd, call_list, ivals, infos)

        def size_pass(fm, lanes, state, rounds=None):
            with spy._lock:
                spy.pass_widths.append(lanes.qrows.shape[1])
            return sized("bwd_pass", spy._real_pass, state.shape[1], fm,
                         lanes, state, rounds)

        def words(*a):
            out = spy._real_words(*a)
            with spy._lock:
                spy.word_dtypes.append(out.dtype)
            return out

        Runtime.__init__ = rt_init
        extend_cuda.extend_batch_kernel = capture
        occ4_cuda.extend_kernel = capture_occ4
        bwd_cuda.run_backward_fused = capture_bwd
        bwd_cuda.bwd_pass_kernel = size_pass
        DeviceSeeder._backward_rows = capture_rows
        device_seed.pack_call_words = words

    @staticmethod
    def kernel_wrappers() -> dict:
        """Each kernel's wrapper, which counts its launches."""
        from mpibwa_tpu_torch.ops import bwd_cuda, extend_cuda, occ4_cuda

        return {"extend": extend_cuda.extend_batch_kernel,
                "occ4_extend": occ4_cuda.extend_kernel,
                "bwd_pass": bwd_cuda.bwd_pass_kernel}

    @property
    def launches(self) -> dict:
        return {name: fn.launches for name, fn in self.wrappers.items()}

    def size_hist(self) -> dict:
        """Per kernel, its launches by batch size in power-of-two buckets
        ("2^k" counts sizes in [2^(k-1), 2^k))."""
        out = {}
        for name, sizes in self.sizes.items():
            hist = {}
            for n in sizes:
                key = f"2^{int(n).bit_length()}"
                hist[key] = hist.get(key, 0) + 1
            out[name] = dict(sorted(hist.items(),
                                    key=lambda kv: int(kv[0][2:])))
        return out

    def close(self):
        from mpibwa_tpu_torch.parallel.runtime import Runtime
        from mpibwa_tpu_torch.pipeline import device_seed
        from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

        Runtime.__init__ = self._rt_init
        DeviceSeeder._backward_rows = self._real_rows
        device_seed.pack_call_words = self._real_words
        extend_cuda, occ4_cuda, bwd_cuda = self._mods
        extend_cuda.extend_batch_kernel = self._real
        occ4_cuda.extend_kernel = self._real_occ4
        bwd_cuda.run_backward_fused = self._real_bwd
        bwd_cuda.bwd_pass_kernel = self._real_pass

    def reset(self):
        for fn in self.wrappers.values():
            fn.launches = 0
        for sizes in self.sizes.values():
            sizes.clear()
        self.runtimes.clear()
        self.pass_widths.clear()
        self.word_dtypes.clear()


def run_cli(workdir: str, argv: "list[str]", spy: Spy, ext: str,
            knobs: "dict | None" = None) -> dict:
    """`cli mem` in workdir with -o out; returns its SAM bytes and stats.
    knobs: environment variables for this run only (MPIBWA_PALLAS and
    MPIBWA_BWD are unset otherwise: the defaults)."""
    from mpibwa_tpu_torch import cli

    os.makedirs(workdir, exist_ok=True)
    os.environ["MPIBWA_EXT"] = ext
    for k in ("MPIBWA_PALLAS", "MPIBWA_BWD"):
        os.environ.pop(k, None)
    os.environ.update(knobs or {})
    cwd = os.getcwd()
    os.chdir(workdir)
    spy.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        rc = cli.main(["mem"] + argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if rc != 0:
            raise Failed(f"cli mem exited {rc}")
        rt = spy.runtimes[-1]
        al = rt.aligners[0]
        chained_in_c = al._native_chainer() is not None
    finally:
        os.chdir(cwd)
        for k in knobs or {}:
            os.environ.pop(k, None)
    with open(os.path.join(workdir, "out.sam"), "rb") as fh:
        sam = fh.read()
    return {"sam": sam, "wall": wall, "align": rt.times["align"],
            "chained_in_c": chained_in_c,
            "launches": spy.launches, "stats": al.stats,
            "seed_times": al.seeder.times,
            "peak": torch.cuda.max_memory_allocated(),
            "sizes": spy.size_hist()}


def check_sam(sam: bytes, n_reads: int) -> float:
    """Record count and mapped share of a SAM; returns the mapped share."""
    recs = [ln for ln in sam.split(b"\n") if ln and not ln.startswith(b"@")]
    flags = np.array([int(r.split(b"\t", 2)[1]) for r in recs])
    primary = flags[(flags & 0x900) == 0]
    if len(primary) != n_reads:
        raise Failed(f"{len(primary)} primary records for {n_reads} reads")
    mapped = float(np.mean((primary & 4) == 0))
    if mapped < 0.9:
        raise Failed(f"only {mapped:.3f} of the reads mapped")
    return mapped


def require_c_chain(tag: str, r: dict) -> None:
    """A default run must chain in C: no microbatch may have fallen to the
    record route."""
    if not r["chained_in_c"] or r["stats"]["cigar_problems"]:
        raise Failed(f"{tag}: the C chain stage was unavailable (the run "
                     f"took the record route)")


def report_run(tag: str, r: dict, n_reads: int) -> None:
    st = r["stats"]
    t = {k: round(v, 3) for k, v in st["t"].items()}
    seed = {k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in r["seed_times"].items()}
    log(f"{tag} on {torch.cuda.get_device_name(0)}: {n_reads} reads in "
        f"{r['align']:.2f}s aligning ({n_reads / r['align']:.1f} reads/s), "
        f"{r['wall']:.2f}s wall incl. "
        f"index load ({n_reads / r['wall']:.1f} reads/s); kernel launches="
        f"{r['launches']}; fallback_reads={st['fallback_reads']}; "
        f"overflow_microbatches={st['overflow_batches']}; ext_problems="
        f"{st['ext_problems']}; peak device memory "
        f"{r['peak'] / 2**30:.3f} GiB")
    log(f"{tag} stage seconds: aligner {t}; seeder {seed}")


def cli_opt(preset=None):
    """The options `cli mem -t 1 [-x preset]` builds."""
    from mpibwa_tpu_torch.core import opts as O

    opt = O.mem_opt_init()
    opt.n_threads = 1
    if preset:
        O.apply_preset(opt, preset, set())
    else:
        O.rescale_by_a(opt, set(), preset=None)
    opt.mat = O.fill_scmat(opt.a, opt.b)
    opt.round_float_fields()
    return opt


@functools.lru_cache(maxsize=1)
def host_index(ref: str):
    """The index files of ref, loaded once for every host-engine run."""
    from mpibwa_tpu_torch.index.format import load_index

    return load_index(ref)


def host_engine_sam(workdir, ref, r1, r2, argv, preset=None) -> bytes:
    """The host spec engine (core/) on the same input, with the header the
    CLI writes for argv (`-x preset` among them where given)."""
    from mpibwa_tpu_torch.io import headers as hdr
    from mpibwa_tpu_torch.parallel.runtime import Runtime

    opt = cli_opt(preset)
    rt = Runtime(host_index(ref), opt, use_device=False,
                 fixed_chunk_size=opt.chunk_size * opt.n_threads,
                 verbose=False)
    os.makedirs(workdir, exist_ok=True)
    out = os.path.join(workdir, "out")
    rt.run(r1, r2, out,
           pg_line=hdr.make_pg_line(["mpibwa-tpu", "mem"] + argv))
    with open(out + ".sam", "rb") as fh:
        return fh.read()


def write_reads(path, reads):
    with open(path, "w") as fh:
        for name, s in reads:
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")


# -- phases 2c, 2d: the block-layout kernels against their plain versions -----

def seeded_intervals(rng, fm, n: int) -> torch.Tensor:
    """(n, 3) int32 bi-intervals inside the BWT on fm's device: sizes 1..200
    (an eighth of them 1), rows at the sentinel position (x = 0), rows that
    span ``primary`` or end on it, and rows at the last position."""
    x2 = rng.integers(1, 200, n)
    x2[: n // 8] = 1
    hi = fm.seq_len + 1 - x2
    x0 = rng.integers(0, hi + 1)
    x1 = rng.integers(0, hi + 1)
    x0[:4] = x1[4:8] = 0
    for j, d in enumerate(range(-3, 4)):
        x0[8 + j] = x1[16 + j] = fm.primary + d
        x2[8 + j] = x2[16 + j] = 3
    x0[24] = x1[25] = fm.primary
    x0[26] = x1[27] = fm.seq_len
    x2[24:28] = 1
    ik = np.stack([x0, x1, x2], axis=1).astype(np.int32)
    return torch.from_numpy(ik).to(fm.device)


def block_ids(fm, k: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The distinct block rows that bwt_extend reads for intervals of rank
    side k and size s: the 128-bp blocks of the ends k-1 and k-1+s, none
    for a sentinel end (position < 0)."""
    n_blocks = fm.fused_blocks().shape[0]
    p = torch.cat([k.long() - 1, k.long() - 1 + s.long()])
    p = p[p >= 0]
    return torch.unique(
        ((p - (p >= fm.primary).long()) >> 7).clamp(0, n_blocks - 1))


def occ4_bytes(fm, ik: torch.Tensor) -> "tuple[float, int]":
    """(bytes, block rows) a backward extension of ik needs: 12 B in and
    48 B out an entry, 48 B for each distinct block row of the batch."""
    rows = int(block_ids(fm, ik[:, 0], ik[:, 2]).numel())
    return 60.0 * ik.shape[0] + 48.0 * rows, rows


def phase2c(rng, fm, main_ik, toy) -> dict:
    """occ4 kernel == extend_blocks (== the O2 extend on seeded intervals),
    timed at every E and at the main path's largest batch. Returns the
    kernels-line numbers."""
    from mpibwa_tpu_torch.ops.occ4_cuda import extend_blocks, extend_kernel

    worst = 0
    res = {}
    cases = [("seeded", seeded_intervals(rng, fm, E))
             for E in (1_000, 65_536, 1_048_576)]
    cases.append(("captured from phase 8 (main path)", main_ik))
    cases += [(f"edge case {name}", torch.from_numpy(ik).to(fm.device))
              for name, ik in toy.occ4_edge_intervals(
                  fm, int(rng.integers(1 << 30))).items()]
    for tag, ik in cases:
        E = ik.shape[0]
        err = 0
        for is_back in (1, 0):
            got = extend_kernel(fm, ik, is_back)
            torch.cuda.synchronize()
            want = extend_blocks(fm, ik, is_back)
            err = max(err, max_err(got, want))
            if tag == "seeded":  # valid intervals: the O2 path agrees too
                err = max(err, max_err(got, fm.extend(ik, is_back)))
        worst = max(worst, err)
        if tag.startswith("edge"):
            log(f"phase 2c occ4 kernel, {tag}, E={E}: max_abs_err={err} "
                f"(both directions)")
            continue
        ms = median_ms(lambda: extend_kernel(fm, ik, 1), 5)
        plain_ms = median_ms(lambda: extend_blocks(fm, ik, 1), 5)
        o2_ms = median_ms(lambda: fm.extend(ik, 1), 5)
        nbytes, rows = occ4_bytes(fm, ik)
        b_ms, b_by = bound(nbytes, OPS_PER_EXTENSION * E)
        log(f"phase 2c occ4 kernel, {tag}, E={E}: max_abs_err={err} (both "
            f"directions); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, O2 "
            f"extend {o2_ms:.4f} ms (medians of 5 after a warm-up, CUDA "
            f"events); bound {b_ms:.5f} ms by {b_by} ({rows} distinct block "
            f"rows, {rows / E:.3f} an entry; {nbytes / E:.1f} B an entry)")
        res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by}
    if worst:
        raise Failed("occ4 kernel disagrees with its plain version")
    return dict(res, max_abs_err=worst)


def pass_counts(fm, lanes, state0) -> "tuple[torch.Tensor, dict]":
    """The plain pass round by round from state0: its final state, and its
    rounds, live entry-rounds, warp-rounds (lane-rounds with a live entry:
    one warp each), slot-rounds (the 32-entry slots those warps step) and
    the distinct block rows the whole pass reads (the union over rounds)."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    L = lanes.qrows.shape[1]
    n_lane = (lanes.lane_off[1:] - lanes.lane_off[:-1]).long()
    st = state0.clone()
    c = {"rounds": 0, "live_rounds": 0, "warp_rounds": 0, "slot_rounds": 0}
    ids = []
    while c["rounds"] < L + 2 and bool(st[BC.LIVE].any()):
        live = st[BC.LIVE] != 0
        c["live_rounds"] += int(live.sum())
        lv = torch.unique(lanes.lane_e[live])
        c["warp_rounds"] += int(lv.numel())
        c["slot_rounds"] += int(((n_lane[lv] + 31) // 32).sum())
        i = st[BC.I].long()
        qi = lanes.qrows[lanes.lane_e, i.clamp(0, L - 1)]
        ext = live & (i >= 0) & (i < L) & (qi < 4)
        ids.append(block_ids(fm, st[BC.IK0][ext], st[BC.IK2][ext]))
        st = BC.bwd_round(fm, lanes, st)
        c["rounds"] += 1
    c["rows"] = int(torch.unique(torch.cat(ids)).numel()) if ids else 0
    return st, c


def check_pass(fm, lanes, state0, want, want_rounds: int,
               max_len=None) -> "tuple[int, torch.Tensor]":
    """The pass kernel on a copy of state0, at the slot count of max_len
    (the lanes' own by default): exactly one launch, and (the max abs
    difference from want over all 7 state arrays and the round count, the
    kernel's state)."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    st = state0.clone()
    rounds = torch.zeros(1, dtype=torch.int32, device=st.device)
    n0 = BC.bwd_pass_kernel.launches
    BC.bwd_pass_kernel(fm, lanes if max_len is None
                       else lanes._replace(max_len=max_len), st, rounds)
    torch.cuda.synchronize()
    if BC.bwd_pass_kernel.launches != n0 + 1:
        raise Failed("a backward pass took other than one launch")
    return max(max_err(st, want), abs(int(rounds[0]) - want_rounds)), st


def phase2d(fm, call, toy, seed: int) -> dict:
    """Pass kernel == bwd_pass over the captured entry state (all 7 state
    arrays, the round count, the mems) and over the edge lanes at every
    slot count; a whole pass timed; its bound over the pass."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    qrows, entry, x0, minv, lane_off = call
    dev = qrows.device
    lanes, state0 = BC.entry_state(qrows, entry, x0, minv, lane_off)
    E, NL, L = state0.shape[1], qrows.shape[0], qrows.shape[1]
    want, c = pass_counts(fm, lanes, state0)
    worst, kst = check_pass(fm, lanes, state0, want, c["rounds"])
    mems_k, _ = BC.pull_rows(BC.pack_emitted(kst, entry[1], lanes.lane_e), E)
    mems_p, _ = BC.pull_rows(BC.pack_emitted(want, entry[1], lanes.lane_e),
                             E)
    if mems_k.shape != mems_p.shape or (mems_k != mems_p).any():
        raise Failed("pass kernel and plain pass emit different mems")

    pk = toy.pack_bwd_lanes(toy.bwd_edge_lanes(fm, seed))
    entries = tuple(torch.from_numpy(pk[k]).to(dev)
                    for k in ("ik", "info", "lane", "live"))
    e_want0 = None
    # the rows as they are, then padded to WIDE_ROW bp: past 12,288 bp the
    # kernel reads each lane's row in place (Lp = 0) instead of staging it
    # in shared memory
    for width in (pk["q"].shape[1], WIDE_ROW):
        q = np.pad(pk["q"], ((0, 0), (0, width - pk["q"].shape[1])),
                   constant_values=4)
        el, es = BC.entry_state(torch.from_numpy(q).to(dev), entries,
                                pk["x0"], pk["minv"], pk["lane_off"])
        e_rounds = torch.zeros(1, dtype=torch.int32, device=dev)
        e_want = BC.bwd_pass(fm, el, es.clone(), e_rounds)
        if e_want0 is None:
            e_want0 = (e_want, int(e_rounds[0]))
        elif (max_err(e_want, e_want0[0]) or int(e_rounds[0]) != e_want0[1]):
            raise Failed("the plain pass changed with padded query rows")
        where = ("Lp = 0, read in place"
                 if 4 * ((width + 15) & ~15) > 48 * 1024
                 else "staged in shared memory")
        for max_len in (1, 33, 65, 129):  # slot counts 1, 2, 4, 8
            err, _ = check_pass(fm, el, es, e_want, int(e_rounds[0]),
                                max_len)
            worst = max(worst, err)
            log(f"phase 2d pass kernel, edge lanes of tests/_torch_toy.py "
                f"({pk['NL']} lanes, E={pk['E']}, longest {el.max_len}, "
                f"{int(e_rounds[0])} rounds, query rows of {width} bp: "
                f"{where}) at {BC.slot_count(max_len)} slot(s): max_abs_err={err} "
                f"over all 7 state arrays and the round count")

    reps = 5
    copies = [state0.clone() for _ in range(reps + 1)]
    ms = median_ms(lambda: BC.bwd_pass_kernel(fm, lanes, copies.pop()),
                   reps)
    copies = [state0.clone() for _ in range(reps + 1)]
    plain_ms = median_ms(lambda: BC.bwd_pass(fm, lanes, copies.pop()), reps)
    # every byte once over the pass: 7 state words of each entry in and out
    # (56 B), each lane's query row, offsets and min_intv (L + 8 B), each
    # distinct block row (48 B)
    nbytes = 56 * E + NL * (L + 8) + 48 * c["rows"]
    b_ms, b_by = bound(nbytes, OPS_PER_EXTENSION * c["live_rounds"])
    log(f"phase 2d pass kernel, entry state of phase 4's first backward "
        f"call: E={E} entries, {NL} lanes (longest {lanes.max_len}: "
        f"{BC.slot_count(lanes.max_len)} slot(s)), {c['rounds']} rounds, "
        f"{c['live_rounds']} live entry-rounds in {c['warp_rounds']} "
        f"warp-rounds stepping {c['slot_rounds']} slots (live thread share "
        f"{c['live_rounds'] / (32 * max(c['warp_rounds'], 1)):.4f} of 32 a "
        f"warp-round, {c['live_rounds'] / (32 * max(c['slot_rounds'], 1)):.4f}"
        f" of 32 a slot), {c['rows']} distinct block rows over the pass, "
        f"{len(mems_k)} mems: max_abs_err={worst} over all 7 state arrays, "
        f"the round count and the edge lanes, mems equal; one launch a "
        f"pass: kernel {ms:.4f} ms, plain pass {plain_ms:.4f} ms (medians of "
        f"{reps} after a warm-up, CUDA events); the earlier round kernel at "
        f"this shape {OLD_PASS_MS} ms a pass, {OLD_LAUNCH_MS} ms a launch "
        f"(PERF.md); bound {b_ms:.5f} ms by {b_by} ({nbytes} B, "
        f"{OPS_PER_EXTENSION * c['live_rounds']:.0f} operations), "
        f"{b_ms / ms:.4f} of the kernel's time")
    if worst:
        raise Failed("pass kernel disagrees with its plain pass")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


WIDE_READS = 16_384  # phase 2e: the first microbatch of phase 4's input
WIDE_ROW = 16_384  # phase 2d: query rows padded past the kernel's 12,288


def phase2e(ref: str, fm32, reads) -> None:
    """The int64 position path on the phase 3 genome: collect_flat under v8
    == v8 on the int32 index (all three arrays), flat and contig == v8 on
    (x0, x2, info), the offsets and the fallback flags; v8, flat and contig
    timed in turns (medians of 3 after a warm-up) with peak device
    memory."""
    from mpibwa_tpu_torch.core.opts import mem_opt_init
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    t0 = time.time()
    wide = DeviceFMIndex(host_index(ref), fm32.device, force_wide=True)
    torch.cuda.synchronize()
    log(f"phase 2e int64 index (force_wide) of the phase 3 genome on the "
        f"card in {time.time() - t0:.1f} s")
    qs = [s.seq for s in reads]
    seeders = {k: DeviceSeeder(fm, mem_opt_init()) for k, fm in
               (("v8 int32", fm32), ("v8", wide), ("flat", wide),
                ("contig", wide))}

    def run(key):
        os.environ["MPIBWA_BWD"] = key.split()[0]
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = seeders[key].collect_flat(qs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        finally:
            os.environ.pop("MPIBWA_BWD", None)
        if out is None:
            raise Failed(f"phase 2e: collect_flat under {key} overflowed")
        return out, dt

    wrappers = Spy.kernel_wrappers()
    n0 = {k: fn.launches for k, fn in wrappers.items()}
    out = {k: run(k)[0] for k in seeders}  # the warm-up
    same32 = all(np.array_equal(a, b)
                 for a, b in zip(out["v8"], out["v8 int32"]))
    a = out["v8"]

    def meets_v8(b):
        return (np.array_equal(a[0][:, [0, 2, 3]], b[0][:, [0, 2, 3]])
                and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]))

    same_flat, same_contig = meets_v8(out["flat"]), meets_v8(out["contig"])
    log(f"phase 2e {len(qs)} reads, {len(a[0])} seed rows, "
        f"{int(a[2].sum())} reads to the host engine: v8 int64 == v8 int32 "
        f"(all three arrays): {same32}; flat int64 == v8 int64 on (x0, x2, "
        f"info), offsets and fallback: {same_flat}; contig int64 == v8 int64 "
        f"on the same: {same_contig}")
    if not (same32 and same_flat and same_contig):
        raise Failed("phase 2e: the int64 path disagrees")
    times = {"v8": [], "flat": [], "contig": []}
    peak = {k: 0 for k in times}
    for _ in range(3):
        for key in times:
            torch.cuda.reset_peak_memory_stats()
            got, dt = run(key)
            peak[key] = max(peak[key], torch.cuda.max_memory_allocated())
            times[key].append(dt)
            if not all(np.array_equal(x, y) for x, y in zip(got, out[key])):
                raise Failed(f"phase 2e: {key} changed between runs")
    launched = {k: fn.launches - n0[k] for k, fn in wrappers.items()}
    log(f"phase 2e kernel launches over its collect_flat runs: {launched}")
    v8, fl = times["v8"], times["flat"]  # turns: v8, flat, contig, v8, ...
    beats = all(v8[i] < fl[i] and (i == 0 or v8[i] < times["contig"][i - 1])
                for i in range(3))
    ct = times["contig"]
    c_beats = all(ct[i] < fl[i] and (i == 2 or ct[i] < v8[i + 1])
                  for i in range(3))
    log(f"phase 2e int64: v8 {'beats' if beats else 'does not beat'} flat "
        f"in every turn, and its other neighbour (contig) too; contig "
        f"{'beats' if c_beats else 'does not beat'} both of its neighbours "
        f"(flat before, v8 after) in every turn")
    for key in times:
        st = {k: round(v, 3) if isinstance(v, float) else v
              for k, v in seeders[key].times.items()}
        log(f"phase 2e int64 {key}: collect_flat {np.median(times[key]):.3f} "
            f"s (median of 3 after a warm-up, in turns; "
            f"{', '.join(f'{t:.3f}' for t in times[key])}); peak device "
            f"memory {peak[key] / 2**30:.3f} GiB (both indexes resident); "
            f"over its 4 runs: {st}")


def phase2f(call, seed_times: dict) -> None:
    """The default's first pass-1 backward of phase 4 replayed, each part
    timed alone (median of 5, a synchronize around each): what a bwd1 call
    is made of, beside the per-lane-list route the raw rows replace."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC
    from mpibwa_tpu_torch.ops import seeding_flat as SF

    seeder, qd, calls, ivals, infos = call
    fm = seeder.dfm
    msl = seeder.opt.min_seed_len

    def timed(fn, reps=5):
        out, ms = None, []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return out, float(np.median(ms[1:]))

    def tables():
        arr = calls.astype(np.int64)
        lane_off = np.zeros(len(arr) + 1, np.int64)
        np.cumsum(arr[:, 2], out=lane_off[1:])
        lane_tbl = np.stack([arr[:, 1], arr[:, 2], lane_off[:-1]],
                            axis=1).astype(np.int32)
        lrow = torch.from_numpy(arr[:, 0].astype(np.int32)).to(qd.device)
        ent = SF.assemble_entries(ivals, infos, lrow,
                                  torch.from_numpy(lane_tbl).to(qd.device),
                                  int(lane_off[-1]))
        return arr, lane_off, qd[lrow.long()], ent

    (arr, lane_off, qrows, ent), ms_tab = timed(tables)
    (lanes, state0), ms_state = timed(lambda: BC.entry_state(
        qrows, ent, arr[:, 3], arr[:, 4], lane_off))
    states = [state0.clone() for _ in range(6)]
    st, ms_kernel = timed(lambda: BC.bwd_pass_kernel(fm, lanes, states.pop()))
    N = len(arr)
    (rows, _), ms_rows = timed(lambda: BC.pull_rows(
        BC.pack_emitted(st, ent[1], lanes.lane_e, msl), N // 8 + 1024))

    def lists_route():
        every, _ = BC.pull_rows(BC.pack_emitted(st, ent[1], lanes.lane_e),
                                st.shape[1])
        mems = [[] for _ in range(N)]
        for x0, x1, x2, start, end, ln in every.tolist():
            mems[ln].append((x0, x1, x2, (start << 32) | end))
        out = []
        for ln, mem in enumerate(mems):
            for iv in mem:
                s_, e_ = iv[3] >> 32, iv[3] & 0xFFFFFFFF
                if e_ - s_ >= msl:
                    out.append((iv[0], iv[1], iv[2], s_, e_, ln))
        return np.array(out, np.int32).reshape(-1, 6), len(every)

    (old_rows, n_all), ms_lists = timed(lists_route)
    if not np.array_equal(old_rows, rows):
        raise Failed("phase 2f: raw rows differ from the list route's")
    _, ms_whole = timed(lambda: seeder._backward_rows(qd, calls, ivals,
                                                      infos))
    log(f"phase 2f the default's first pass-1 backward of phase 4 ({N} "
        f"lanes, E={st.shape[1]}, {n_all} mems, {len(rows)} of at least "
        f"{msl} bases), ms (medians of 5 after a warm-up): lane tables, "
        f"uploads and entries {ms_tab:.3f}; entry state {ms_state:.3f}; pass "
        f"kernel {ms_kernel:.3f}; rows compacted and pulled {ms_rows:.3f}; "
        f"the whole raw route (_backward_rows) {ms_whole:.3f}; the "
        f"per-lane-list route in place of the compaction {ms_lists:.3f}; "
        f"phase 4's bwd1 over the run {seed_times.get('bwd1', 0.0):.3f} s")


# -- phases 12, 13: the record route and the launcher -------------------------

class RecordSpy:
    """Wraps the record route's device DPs (ops/global_batch.py
    global_from_coords and traceback_batch, ops/rescue.py striped_sw_u8):
    counts their calls, keeps the device of what they return and puts a
    CUDA event pair around each call."""

    def __init__(self):
        from mpibwa_tpu_torch.ops import global_batch, rescue

        self._mods = (global_batch, rescue)
        self._real = (global_batch.global_from_coords,
                      global_batch.traceback_batch, rescue.striped_sw_u8)
        self.reset()

        def timed(kind, fn):
            def wrapper(*a, **k):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = fn(*a, **k)
                ev[1].record()
                self.events[kind].append(ev)
                self.devices.add(out[0].device.type)
                return out
            return wrapper

        global_batch.global_from_coords = timed("global", self._real[0])
        global_batch.traceback_batch = timed("global", self._real[1])
        rescue.striped_sw_u8 = timed("rescue", self._real[2])

    def reset(self):
        self.events = {"global": [], "rescue": []}
        self.devices = set()

    def ms(self, kind: str) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events[kind])

    def close(self):
        global_batch, rescue = self._mods
        (global_batch.global_from_coords, global_batch.traceback_batch,
         rescue.striped_sw_u8) = self._real


RECORD_KNOBS = {"MPIBWA_FINAL": "python", "MPIBWA_CHAIN": "python"}


def phase12(work, base, paths, spy, want, n_pairs, smi) -> None:
    """The record route on the first pairs, PE and SE: SAM equal to the
    default route's (want: {"PE": bytes, "SE": bytes}), kernels 1 and 2
    launched, the global DP and the rescue SW on the card."""
    rec = RecordSpy()
    try:
        for tag, files, n_reads in (("PE", [paths["h1"], paths["h2"]],
                                     2 * n_pairs),
                                    ("SE", [paths["h1"]], n_pairs)):
            rec.reset()
            r = run_cli(os.path.join(work, "record_" + tag.lower()),
                        base + files, spy, "device", RECORD_KNOBS)
            torch.cuda.synchronize()
            st = r["stats"]
            t = {k: round(v, 3) for k, v in st["t"].items()}
            same = r["sam"] == want[tag]
            log(f"phase 12 record route {tag} on {smi}: {n_reads} reads in "
                f"{r['align']:.2f}s aligning ({n_reads / r['align']:.1f} "
                f"reads/s), {r['wall']:.2f}s wall; stage seconds {t}; "
                f"kernel launches={r['launches']}; global-DP problems "
                f"{st['cigar_problems']} in {len(rec.events['global']) // 2} "
                f"calls, {rec.ms('global'):.3f} ms (global_from_coords + "
                f"traceback_batch, CUDA events around each call, summed); "
                f"rescue SW problems {st['rescue_problems']} in "
                f"{len(rec.events['rescue'])} striped_sw_u8 calls (forward "
                f"and reverse passes), {rec.ms('rescue'):.3f} ms (CUDA "
                f"events); the events count the gaps while the host launches "
                f"the DPs' small ops; outputs on {sorted(rec.devices)}; SAM "
                f"== the default route's: {same}")
            if r["chained_in_c"]:
                raise Failed(f"phase 12 {tag}: the run chained in C")
            for k in ("extend", "bwd_pass"):
                if r["launches"][k] <= 0:
                    raise Failed(f"phase 12 {tag}: no {k} launch")
            if not rec.events["global"] or (tag == "PE"
                                            and not rec.events["rescue"]):
                raise Failed(f"phase 12 {tag}: a device DP never ran")
            if rec.devices != {"cuda"}:
                raise Failed(f"phase 12 {tag}: DPs ran on {rec.devices}")
            if not same:
                raise Failed(f"phase 12 {tag}: the record route's SAM "
                             f"differs from the default route's")
    finally:
        rec.close()


def _no_pg(sam: bytes) -> bytes:
    """A SAM without its @PG line (it quotes the -o argument)."""
    return b"".join(ln for ln in sam.splitlines(True)
                    if not ln.startswith(b"@PG"))


def phase13(work, ref, paths, spy, n_pairs) -> None:
    """`cli launch -n 2` on the first pairs at a -K of about four chunks:
    the merged SAM equals the single-process run's at the same -K, and the
    shard files are gone."""
    from _torch_toy import READ_LEN
    from mpibwa_tpu_torch import cli

    K = str(max(1000, READ_LEN * n_pairs // 2))
    argv = ["-t", "1", "-v", "1", "-K", K, "-o", "out", ref, paths["h1"],
            paths["h2"]]
    one = run_cli(os.path.join(work, "launch_single"), argv, spy, "device")
    require_c_chain("phase 13 single process", one)
    d = os.path.join(work, "launch_n2")
    os.makedirs(d, exist_ok=True)
    cwd = os.getcwd()
    path0 = os.environ.get("PYTHONPATH")
    # the shards run `python -m mpibwa_tpu_torch.cli` from d
    os.environ["PYTHONPATH"] = REPO + (os.pathsep + path0 if path0 else "")
    os.chdir(d)
    t0 = time.time()
    try:
        rc = cli.main(["launch", "-n", "2", "--hosts", "localhost,localhost",
                       "mem"] + argv)
    finally:
        os.chdir(cwd)
        if path0 is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = path0
    wall = time.time() - t0
    if rc != 0:
        raise Failed(f"phase 13: launch exited {rc}")
    with open(os.path.join(d, "out.sam"), "rb") as fh:
        merged = fh.read()
    same = _no_pg(merged) == _no_pg(one["sam"])
    left = [f for f in os.listdir(d) if ".shard" in f]
    log(f"phase 13 launch -n 2 --hosts localhost,localhost mem -K {K} on "
        f"{2 * n_pairs} reads: {wall:.2f}s wall (two shard processes on one "
        f"GPU, each loading the index, then the merge) against "
        f"{one['wall']:.2f}s wall in one process ({one['align']:.2f}s "
        f"aligning); merged SAM == single process (@PG aside): {same}; "
        f"shard files left: {left}")
    if not same or left:
        raise Failed("phase 13: launch -n 2 differs from the single process")


# -- phase 14: long and wide reads ---------------------------------------------

def phase14_long(work, ref, codes, spy, n, seed, smi) -> None:
    """14a: n ONT-like SE reads of 700-2,500 bp (tests/_torch_toy.long_reads:
    5% substitutions, a 3-bp deletion, a 4-bp insertion, every other one
    reverse-complemented, no N) under -x ont2d; 14b: n FR pairs of 400-700
    bp reads, insert N(1,500, 150), with bwa's defaults. Each SAM equal to
    the host spec engine's on the same file; the share of reads the device
    seeder hands to the host engine, reads/s and seconds a read."""
    import _torch_toy as toy

    rng = np.random.default_rng(seed)
    ont = toy.long_reads(codes, rng, [int(v) for v in
                                      rng.integers(700, 2501, n)], 0.0)
    r1, r2 = toy.long_pairs(codes, rng, [int(v) for v in
                                         rng.integers(400, 701, 2 * n)])
    files = {}
    for key, reads in (("ont", ont), ("l1", r1), ("l2", r2)):
        files[key] = os.path.join(work, f"long_{key}.fq")
        name = "ont" if key == "ont" else "pair"  # mates share a name
        write_reads(files[key], [(f"{name}{i}", toy.to_bases(q))
                                 for i, q in enumerate(reads)])
    for tag, opts, fq, preset, n_reads in (
            ("phase 14a ONT-like SE -x ont2d", ["-x", "ont2d"],
             [files["ont"]], "ont2d", n),
            ("phase 14b long PE", [], [files["l1"], files["l2"]], None,
             2 * n)):
        argv = opts + ["-t", "1", "-o", "out", ref] + fq
        d = os.path.join(work, tag.split()[1])
        r = run_cli(d, argv, spy, "device")
        report_run(tag, r, n_reads)
        require_c_chain(tag, r)
        t0 = time.time()
        host = host_engine_sam(d + "_host", ref, fq[0], fq[1] if len(fq) > 1
                               else None, argv, preset)
        t_host = time.time() - t0
        same = host == r["sam"]
        fb = r["stats"]["fallback_reads"]
        bp = sum(len(q) for q in (ont if preset else r1 + r2))
        log(f"{tag} on {smi}: {n_reads} reads, {bp} bp; {fb} of them to the "
            f"host engine (fallback share {fb / n_reads:.3f}); "
            f"{n_reads / r['align']:.2f} reads/s, "
            f"{r['align'] / n_reads:.3f} s a read aligning; the host spec "
            f"engine {t_host:.1f} s ({t_host / n_reads:.3f} s a read); SAM "
            f"== host spec engine: {same}")
        if not same:
            raise Failed(f"{tag}: SAM differs from the host spec engine's")


WIDE_BP = 66_000  # phase 14c: the wide read, past the 16-bit call words
WIDE_BATCH = 16_384  # phase 14c: one microbatch, the wide read last


def phase14_wide(work, ref, codes, short_reads, spy, seed, smi) -> None:
    """14c: phase 7's first WIDE_BATCH - 1 SE reads and, last, a WIDE_BP
    read off the genome (0.1% substitutions, no N) under MPIBWA_EXT=device:
    every short read's lines equal a run on the short reads alone, the
    wide read's equal the host spec engine's at its read id; the call words
    are int64 and every pass launch reads its query row in place."""
    import _torch_toy as toy
    from mpibwa_tpu_torch.core.fm import FMIndex
    from mpibwa_tpu_torch.core.pipeline import process_seqs
    from mpibwa_tpu_torch.core.refseq import RefSeq
    from mpibwa_tpu_torch.io.fastq import read_fastq
    from mpibwa_tpu_torch.ops import seeding
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.pipeline.device_align import DeviceAligner

    rng = np.random.default_rng(seed)
    while True:
        start = int(rng.integers(0, len(codes) - WIDE_BP))
        if not (codes[start: start + WIDE_BP] >= 4).any():
            break
    wide = toy.substituted(rng, codes[start: start + WIDE_BP], 0.001)
    short = list(short_reads[: WIDE_BATCH - 1])
    fq_s = os.path.join(work, "wide_short.fq")
    fq_w = os.path.join(work, "wide.fq")
    write_reads(fq_s, short)
    write_reads(fq_w, short + [("wide", toy.to_bases(wide))])

    # forward steps of pass 1 (one extend1_fwd a step) and the extension
    # callback's time, summed over the C sessions' threads
    count = {"on": False, "steps": 0, "ext_rows_s": 0.0}
    real = (DeviceFMIndex.extend1_fwd, seeding.forward_p3,
            DeviceAligner._ext_rows)

    def ext1(fm, *a):
        count["steps"] += count["on"]
        return real[0](fm, *a)

    def p3(*a):
        count["on"] = True
        try:
            return real[1](*a)
        finally:
            count["on"] = False

    def ext_rows(al, *a, **k):
        t = time.time()
        try:
            return real[2](al, *a, **k)
        finally:
            count["ext_rows_s"] += time.time() - t

    DeviceFMIndex.extend1_fwd, seeding.forward_p3 = ext1, p3
    DeviceAligner._ext_rows = ext_rows
    try:
        r = run_cli(os.path.join(work, "wide"), ["-t", "1", "-o", "out",
                                                 ref, fq_w], spy, "device")
    finally:
        (DeviceFMIndex.extend1_fwd, seeding.forward_p3,
         DeviceAligner._ext_rows) = real
    widths, dtypes = list(spy.pass_widths), set(spy.word_dtypes)
    n_short = len(short)
    report_run("phase 14c wide batch", r, n_short + 1)
    require_c_chain("phase 14c", r)
    st = r["seed_times"]
    log(f"phase 14c on {smi}: {n_short} reads of phase 7 and one "
        f"{WIDE_BP}-bp read last; call words {sorted(map(str, dtypes))}; "
        f"{len(widths)} pass launches, query rows {sorted(set(widths))} bp "
        f"(Lp = 0, read in place, past 12,288: "
        f"{all(w > 12_288 for w in widths)}); fwd1 "
        f"{st.get('fwd1', 0.0):.3f} s over {count['steps']} steps "
        f"({st.get('fwd1', 0.0) / max(count['steps'], 1) * 1e3:.3f} ms a "
        f"step); _ext_rows {count['ext_rows_s']:.3f} s summed over the C "
        f"sessions' threads; kernel launches {r['launches']}; peak device "
        f"memory {r['peak'] / 2**30:.3f} GiB")
    for k in ("extend", "bwd_pass"):
        if r["launches"][k] <= 0:
            raise Failed(f"phase 14c: no {k} launch")
    if dtypes != {torch.int64} or not widths or min(widths) <= 12_288:
        raise Failed("phase 14c: the batch did not take the int64 call "
                     "words and the in-place query rows")

    s = run_cli(os.path.join(work, "wide_short"), ["-t", "1", "-o", "out",
                                                   ref, fq_s], spy, "device")
    report_run("phase 14c the short reads alone", s, n_short)

    def body(sam):
        return [ln for ln in sam.splitlines() if not ln.startswith(b"@")]

    lines = body(r["sam"])
    mine = [ln for ln in lines if ln.startswith(b"wide\t")]
    same_short = [ln for ln in lines if not ln.startswith(b"wide\t")] \
        == body(s["sam"])
    t0 = time.time()
    idx = host_index(ref)
    seqs = read_fastq(fq_w)[-1:]
    process_seqs(cli_opt(), FMIndex.from_index(idx), RefSeq(idx), seqs,
                 n_processed=n_short)
    t_host = time.time() - t0
    same_wide = seqs[0].sam.encode().splitlines() == mine
    log(f"phase 14c short reads' lines == the short reads alone: "
        f"{same_short}; the wide read's {len(mine)} line(s) == the host spec "
        f"engine's at read id {n_short}: {same_wide} (host engine "
        f"{t_host:.1f} s)")
    if not (same_short and same_wide and mine):
        raise Failed("phase 14c: the wide batch's SAM differs")


def report_sizes(tag: str, r: dict, kernel: str) -> None:
    """Print a kernel's launches over a main-path run by batch size."""
    log(f"{tag} {kernel} over the run: {r['launches'][kernel]} launches; "
        f"by batch size {json.dumps(r['sizes'][kernel])}")


def profiled_run(tag, workdir, argv, spy, knobs, kernels, base_sam) -> dict:
    """A main-path run again under torch.profiler with CUDA activity only:
    each kernel's own device time summed over all its launches, and the
    device time of everything the run put on the card. Its SAM must equal
    base_sam, where given. Returns per kernel {run_ms, run_launches} and
    the SAM."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = run_cli(workdir, argv, spy, "device", knobs)
    if base_sam is not None and r["sam"] != base_sam:
        raise Failed(f"{tag}: SAM differs from the untraced run's")
    rows = prof.key_averages()
    busy = sum(e.device_time_total for e in rows) / 1e6
    out = {"sam": r["sam"]}
    for kernel in kernels:
        mine = [e for e in rows if SYMBOLS[kernel] in e.key]
        dev_ms = sum(e.device_time_total for e in mine) / 1e3
        n = sum(e.count for e in mine)
        if n != r["launches"][kernel] or n <= 0:
            raise Failed(f"{tag}: {n} {kernel} launches traced of "
                         f"{r['launches'][kernel]}")
        log(f"{tag} {kernel} device time over the run (torch.profiler, CUDA "
            f"activity only): {n} launches, {dev_ms:.4f} ms = "
            f"{dev_ms / n:.4f} ms a launch, by batch size "
            f"{json.dumps(r['sizes'][kernel])}")
        out[kernel] = {"run_ms": dev_ms, "run_launches": n}
    log(f"{tag} everything on the card {busy:.3f} s in {r['align']:.2f} s "
        f"of align time (busy share {busy / r['align']:.3f})")
    return out


def knob_run(tag, workdir, argv, spy, knobs, kernels, base_sam, n_reads,
             absent=()):
    """A main-path run under knobs: each of its kernels launched, none of
    the absent ones, its SAM equal to base_sam (phase 4's)."""
    r = run_cli(workdir, argv, spy, "device", knobs)
    report_run(tag, r, n_reads)
    require_c_chain(tag, r)
    same = r["sam"] == base_sam
    log(f"{tag} SAM == phase 4's: {same}")
    for kernel in kernels:
        if r["launches"][kernel] <= 0:
            raise Failed(f"{tag}: the main path launched no {kernel} kernel")
    for kernel in absent:
        if r["launches"][kernel] != 0:
            raise Failed(f"{tag}: {kernel} launched under {knobs}")
    if not same:
        raise Failed(f"{tag}: SAM differs from the default run's")
    return r


def backward_stages(r: dict, n_reads: int) -> str:
    """reads/s and the seeding stages of a run, for phase 9's turns."""
    st = r["seed_times"]
    return (f"{n_reads / r['align']:.1f} reads/s (align {r['align']:.2f} s), "
            f"fwd1 {st.get('fwd1', 0.0):.3f} s, bwd1 "
            f"{st.get('bwd1', 0.0):.3f} s, pass2 {st.get('pass2', 0.0):.3f} s "
            f"(p2_fwd {st.get('p2_fwd', 0.0):.3f} s, p2_bwd "
            f"{st.get('p2_bwd', 0.0):.3f} s), bwd_segments "
            f"{st.get('bwd_segments', 0)}, bwd_rounds "
            f"{st.get('bwd_rounds', 0)}, p2_spec {st.get('p2_spec', 0)}, "
            f"p2_redo {st.get('p2_redo', 0)}, v8_redo {st.get('v8_redo', 0)}, "
            f"overflow_microbatches {r['stats']['overflow_batches']}, pass "
            f"kernel launches {r['launches']['bwd_pass']}, peak device memory "
            f"{r['peak'] / 2**30:.3f} GiB")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=50_000)
    ap.add_argument("--host-pairs", type=int, default=1_000)
    ap.add_argument("--genome-bp", type=int, default=248_956_422)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--traced-pairs", type=int, default=5_000,
                    help="pairs of the traced runs of phase 10")
    ap.add_argument("--long-reads", type=int, default=20,
                    help="reads of phase 14a and pairs of phase 14b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _torch_toy
    from mpibwa_tpu_torch.core.opts import fill_scmat

    t_start = time.time()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    rng = np.random.default_rng(args.seed)
    mat = torch.from_numpy(fill_scmat(1, 4).reshape(5, 5).astype(np.int32)
                           ).to(dev)
    worst = phase2_random(rng, dev, mat, _torch_toy)

    t0 = time.time()
    ref, chrom = build_genome(args.seed, args.genome_bp)
    log(f"phase 3 genome: {args.genome_bp} bp indexed at {ref} in "
        f"{time.time() - t0:.1f}s")

    work = os.path.join(REPO, "build", "smoke")
    r1l, r2l = _torch_toy.simulate_pairs({"chr1": chrom}, args.pairs,
                                         seed=args.seed + 1)
    codes = _torch_toy.to_codes(chrom)  # phase 14's reads
    del chrom
    paths = {}
    for tag, reads in (("r1", r1l), ("r2", r2l), ("h1", r1l[: args.host_pairs]),
                       ("h2", r2l[: args.host_pairs])):
        paths[tag] = os.path.join(work, tag + ".fq")
        os.makedirs(work, exist_ok=True)
        write_reads(paths[tag], reads)

    spy = Spy()
    base = ["-t", "1", "-o", "out", ref]
    # phase 4: the main path, extension DP and backward passes in kernels
    pe = run_cli(os.path.join(work, "pe_device"),
                 base + [paths["r1"], paths["r2"]], spy, "device")
    n_pe = 2 * args.pairs
    mapped = check_sam(pe["sam"], n_pe)
    launches = {k: pe["launches"][k] for k in ("extend", "bwd_pass")}
    report_run("phase 4 PE device", pe, n_pe)
    require_c_chain("phase 4", pe)
    log(f"phase 4 mapped share {mapped:.4f}")
    for k in ("extend", "bwd_pass"):
        report_sizes("phase 4", pe, k)
        if launches[k] <= 0:
            raise Failed(f"the main path launched no {k} kernel")
    log(f"phase 4 backward: {backward_stages(pe, n_pe)}")
    captured = list(spy.captured)

    # phase 5: every DP scalar in C
    nat = run_cli(os.path.join(work, "pe_native"),
                  base + [paths["r1"], paths["r2"]], spy, "native")
    report_run("phase 5 PE native", nat, n_pe)
    require_c_chain("phase 5", nat)
    same = nat["sam"] == pe["sam"]
    log(f"phase 5 SAM device == native: {same}")
    if not same:
        raise Failed("MPIBWA_EXT=device and native SAM differ")

    # phase 6: the host spec engine on the first pairs
    hargv = base + [paths["h1"], paths["h2"]]
    port = run_cli(os.path.join(work, "pe_host_port"), hargv, spy, "device")
    require_c_chain("phase 6", port)
    default_sam = {"PE": port["sam"]}
    t0 = time.time()
    host = host_engine_sam(os.path.join(work, "pe_host"), ref, paths["h1"],
                           paths["h2"], hargv)
    same = host == port["sam"]
    log(f"phase 6 PE {2 * args.host_pairs} reads: port == host spec engine: "
        f"{same} (host engine {time.time() - t0:.1f}s)")
    if not same:
        raise Failed("port and host spec engine SAM differ (PE)")

    # phase 7: SE
    se = run_cli(os.path.join(work, "se_device"), base + [paths["r1"]], spy,
                 "device")
    check_sam(se["sam"], args.pairs)
    report_run("phase 7 SE device", se, args.pairs)
    require_c_chain("phase 7", se)
    for k in ("extend", "bwd_pass"):
        if se["launches"][k] <= 0:
            raise Failed(f"the SE main path launched no {k} kernel")
    hargv = base + [paths["h1"]]
    port = run_cli(os.path.join(work, "se_host_port"), hargv, spy, "device")
    require_c_chain("phase 7", port)
    default_sam["SE"] = port["sam"]
    t0 = time.time()
    host = host_engine_sam(os.path.join(work, "se_host"), ref, paths["h1"],
                           None, hargv)
    same = host == port["sam"]
    log(f"phase 7 SE {args.host_pairs} reads: port == host spec engine: "
        f"{same} (host engine {time.time() - t0:.1f}s)")
    if not same:
        raise Failed("port and host spec engine SAM differ (SE)")

    # phase 8: the flat backward engine, its rounds through kernel 3
    pe_argv = base + [paths["r1"], paths["r2"]]
    knobs8 = {"MPIBWA_BWD": "flat", "MPIBWA_PALLAS": "1"}
    r8 = knob_run("phase 8 PE MPIBWA_BWD=flat MPIBWA_PALLAS=1",
                  os.path.join(work, "pe_occ4"), pe_argv, spy, knobs8,
                  ["occ4_extend"], pe["sam"], n_pe, absent=["bwd_pass"])
    launches["occ4_extend"] = r8["launches"]["occ4_extend"]
    report_sizes("phase 8", r8, "occ4_extend")
    # phase 9: flat, contig, the default, v8 (phase 11), the default, in
    # turns after phase 8
    r9f = knob_run("phase 9 PE MPIBWA_BWD=flat", os.path.join(work, "pe_flat"),
                   pe_argv, spy, {"MPIBWA_BWD": "flat"}, ["extend"],
                   pe["sam"], n_pe, absent=["bwd_pass"])
    # the contig engine (opt-in, no kernel of its own)
    r9c = knob_run("phase 9 PE MPIBWA_BWD=contig",
                   os.path.join(work, "pe_contig"), pe_argv, spy,
                   {"MPIBWA_BWD": "contig"}, ["extend"], pe["sam"], n_pe,
                   absent=["bwd_pass"])
    r9d = knob_run("phase 9 PE default", os.path.join(work, "pe_default"),
                   pe_argv, spy, {}, ["extend", "bwd_pass"], pe["sam"], n_pe)
    report_sizes("phase 9 default", r9d, "bwd_pass")
    # phase 11: the v8 engine on the main path (no kernel of its own)
    r11 = knob_run("phase 11 PE MPIBWA_BWD=v8", os.path.join(work, "pe_v8"),
                   pe_argv, spy, {"MPIBWA_BWD": "v8"}, ["extend"], pe["sam"],
                   n_pe, absent=["bwd_pass"])
    log(f"phase 11 v8: {backward_stages(r11, n_pe)}")
    r9d2 = knob_run("phase 9 PE default again",
                    os.path.join(work, "pe_default2"), pe_argv, spy, {},
                    ["extend", "bwd_pass"], pe["sam"], n_pe)
    rate = {k: n_pe / r["align"] for k, r in
            (("phase 4", pe), ("flat", r9f), ("contig", r9c),
             ("default", r9d), ("v8", r11), ("default again", r9d2))}
    log(f"phase 9 turns: phase 4 default {backward_stages(pe, n_pe)}; "
        f"MPIBWA_BWD=flat {backward_stages(r9f, n_pe)}; MPIBWA_BWD=contig "
        f"{backward_stages(r9c, n_pe)}; default "
        f"{backward_stages(r9d, n_pe)}; MPIBWA_BWD=v8 "
        f"{backward_stages(r11, n_pe)}; default again "
        f"{backward_stages(r9d2, n_pe)}")
    slower = rate["default"] < rate["flat"] and rate["phase 4"] < rate["flat"]
    log(f"phase 9 the default (pass kernel) is "
        f"{'slower' if slower else 'not slower'} than MPIBWA_BWD=flat "
        f"against both of its neighbours: {rate['phase 4']:.1f} / "
        f"{rate['flat']:.1f} / {rate['default']:.1f} PE reads/s (phase 4, "
        f"flat, default)")
    beats = rate["v8"] > rate["default"] and rate["v8"] > rate["default again"]
    log(f"phase 9 MPIBWA_BWD=v8 {'beats' if beats else 'does not beat'} the "
        f"default against both of its neighbours: {rate['default']:.1f} / "
        f"{rate['v8']:.1f} / {rate['default again']:.1f} PE reads/s "
        f"(default, v8, default again)")
    beats = rate["contig"] > rate["default"] and rate["contig"] > rate["flat"]
    log(f"phase 9 MPIBWA_BWD=contig {'beats' if beats else 'does not beat'} "
        f"both of its neighbours: {rate['flat']:.1f} / {rate['contig']:.1f} "
        f"/ {rate['default']:.1f} PE reads/s (flat, contig, default)")
    # phases 12 and 13: the record route and the launcher on the first pairs
    phase12(work, base, paths, spy, default_sam, args.host_pairs, smi)
    phase13(work, ref, paths, spy, args.host_pairs)
    # phase 14: long and wide reads
    phase14_long(work, ref, codes, spy, args.long_reads, args.seed + 2, smi)
    phase14_wide(work, ref, codes, r1l, spy, args.seed + 3, smi)
    del codes
    # phase 10: the default run and phase 8's again on the first pairs,
    # traced; every traced SAM equals the first one (and phase 4's when
    # the input is the whole of it)
    n_tr = min(args.traced_pairs, args.pairs)
    t_argv = pe_argv
    base_sam = pe["sam"] if n_tr == args.pairs else None
    if n_tr < args.pairs:
        for tag, reads in (("t1", r1l[:n_tr]), ("t2", r2l[:n_tr])):
            paths[tag] = os.path.join(work, tag + ".fq")
            write_reads(paths[tag], reads)
        t_argv = base + [paths["t1"], paths["t2"]]
    log(f"phase 10 traced runs on the first {n_tr} pairs")
    traced = {}
    for kernels, ph, d, kn in (
            (["extend", "bwd_pass"], "default", "pe_device_traced", {}),
            (["occ4_extend"], "phase 8", "pe_occ4_traced", knobs8)):
        got = profiled_run(f"phase 10 ({ph})", os.path.join(work, d),
                           t_argv, spy, kn, kernels, base_sam)
        base_sam = got.pop("sam")
        traced.update(got)
    fm = spy.runtimes[-1].aligners[0].dfm  # phase 8's index, on the card
    spy.close()
    if (spy.occ4_ik is None or spy.bwd_call is None
            or spy.rows_call is None):
        raise Failed("no occ4 batch or backward call captured from the main "
                     "path")

    # phase 2b: kernel 1 on the problems of the main path
    from mpibwa_tpu_torch.ops.extend_batch import extend_batch

    if not captured:
        raise Failed("no extension problems captured from the main path")
    ext = {}
    for i, args in enumerate(captured):
        err = extend_err(args, PEN)
        worst = max(worst, err)
        ms = extend_ms(args, PEN, 7)
        B, Q, T = args[0].shape[0], args[0].shape[1], args[1].shape[1]
        line = (f"phase 2b captured call B={B} Q={Q} T={T}: max_abs_err="
                f"{err}; kernel {ms:.4f} ms (median of 7 after a warm-up, "
                f"CUDA events)")
        if i == 0:
            plain_ms = median_ms(lambda: extend_batch(*args, *PEN), 7)
            b_ms, b_by, cells = extend_bound(args)
            line += (f"; plain {plain_ms:.4f} ms; {cells} DP cells visited, "
                     f"bound {b_ms:.5f} ms by {b_by}")
            ext = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by}
        log(line)
    if worst:
        raise Failed("kernel 1 disagrees with the plain version")

    results = {"extend": dict(ext, max_abs_err=worst),
               "occ4_extend": phase2c(rng, fm, spy.occ4_ik, _torch_toy),
               "bwd_pass": phase2d(fm, spy.bwd_call, _torch_toy,
                                   int(rng.integers(1 << 30)))}
    phase2e(ref, fm, [s for pair in zip(
        _torch_toy.load_reads(paths["r1"], limit=WIDE_READS // 2),
        _torch_toy.load_reads(paths["r2"], limit=WIDE_READS // 2))
        for s in pair])
    phase2f(spy.rows_call, pe["seed_times"])

    log(f"total {time.time() - t_start:.1f}s")
    # no single PyTorch call computes any of the three functions
    log(json.dumps({"kernels": [
        dict(KERNELS[k], launches=launches[k], library_ms=None,
             run_pairs=n_tr, **traced[k], **results[k])
        for k in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
