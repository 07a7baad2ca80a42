#!/usr/bin/env python3
"""Drive the torch port's main path once on one NVIDIA GPU and check it.

Phases, one printed line (or more) each:
  1. the card's name and power limit (nvidia-smi);
  2. the seven CUDA kernels' six sources (mpibwa_tpu_torch/csrc/extend.cu,
     occ4_extend.cu, bwd_pass.cu, fwd_automata.cu with kernels 4 and 5,
     sa_walk.cu, bwd_v8.cu) built from the checkout, one nvcc each, all
     started
     together; then kernel 1 held against the plain PyTorch
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
     pass one launch of the pass kernel): kernels 1 and 2, and the
     forward automata (4: forward_p3, 5: forward_pass) and the SA walk (6)
     on every microbatch, none of the three loops' plain versions (launch
     counts reset just before);
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
  11. the v8 turn of phase 9 (PE, MPIBWA_EXT=device, phase 4's input),
     each backward pass one launch of kernel 7 (csrc/bwd_v8.cu): its SAM
     byte-identical to phase 4's, its stages (fwd1, bwd1, pass2 with
     p2_fwd and p2_bwd), host reads of the backward, pass-2 runs on the
     speculative route and redone, v8 passes redone on the flat engine and
     peak device memory;
  15. the default in three turns, kernels / plain loops / kernels: in the
     middle turn the seeder's forward automata and SA walks run their
     plain versions (patched in, no knob); every SAM byte-identical to
     phase 4's; fwd1, p2_fwd and the SA walk (each call timed between two
     synchronizes) of each turn;
  10. the default run, phase 8's and phase 11's once more on the first
     --traced-pairs pairs (5,000) under torch.profiler (CUDA activity
     only): each
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
     input under v8 with kernel 7 (== the plain torch v8 patched in, on
     both indexes, and == v8 on the int32 index, in all three arrays),
     under flat and under contig (each == v8 on (x0, x2, info), the
     offsets and the fallback flags), all timed in turns (medians of 3
     after a warm-up) with peak device memory, the kernels' launches and
     each seeder's stages;
  2i. the int64 main path end to end in process: the DeviceAligner of a
     Runtime at `mem -t 1`'s chunk size over phase 2e's int64 index and
     over the int32 one, on the first 16,384 pairs: byte-identical SAM,
     kernel 7 launched on the int64 index (MPIBWA_BWD=auto), the pass
     kernel on the int32 one;
  2f. the default's pass-1 backward of phase 4's first microbatch
     (DeviceSeeder._backward_rows, captured) replayed and timed in its
     parts (lane tables and entries, entry state, pass kernel, the rows'
     compaction and pull) beside the per-lane-list route it replaces
     (medians of 5, a synchronize around each part);
  2g. kernels 4-6 against their plain versions (every output field equal):
     forward_p3 on phase 4's first microbatch, phase 14a's long reads
     (which overflow F_CAP, C_CAP and S3_CAP) and phase 14c's batch with
     the wide read (the plain loop over its short reads on the card, over
     the wide read alone, about 63,000 host rounds, on the CPU in a side
     process started after phase 15, this script with --plain-wide, while
     phases 12-2f run); forward_pass on pass 2's first lanes (starts,
     min_intv > 1) and chained on phase 4's first microbatch and 14a's
     reads; the SA walk on phase 4's first prefetch plus 0, primary,
     seq_len and multiples of sa_intv (set a), and timed on (b) all but
     its 1% longest walks (the heavy phase), (c) those walks alone (the
     latency tail) and (d) the longest walk alone; phase 4's inputs again
     on phase 2e's int64 index; kernel 7 on the first pass-1 backward of
     phase 11 (int32) and of phase 2i (int64) and on phase 11's first
     pass-2 backward against the plain torch v8 (rows) and its torch trace
     (every entry's outputs), with step 0's counts of its layout (lanes by
     entries, warp-rounds one warp a lane, packed and as the kernel ran
     them, steps and distinct steps, live-thread shares);
     the kernels' registers and spills
     (-Xptxas -v); a dependent-load probe (csrc/sa_walk.cu) over the O2
     table: one thread, a warp on every SM, every SM full, at the card's
     default L2 fetch granularity and again at 32 bytes (then restored);
     kernel times (the kernel
     alone: launches back to back into preallocated outputs), the
     wrapper's call and the plain loop (CUDA events, medians), the bound,
     the latency floor (the longest lane's steps times the probe's lone
     dependent load) and the random-load floor (the steps' sector loads at
     the probe's full-card rate);
  2h. positions past 2**31: a rank table (not a BWT) of 2**31 + 2**24
     positions with random packed words and consistent cumulative counts,
     through DeviceFMIndex.from_numpy; kernels 4, 5 and 7 at int64 held
     exactly to their plain versions on A-rich reads whose intervals lie
     above 2**31 (kernel 6 left out: on such a table a walk need not end);
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
Phases 4, 8, 9 and 11 print each kernel's launches by batch size; every
default-chaining run (phases 4-11, 14, 15) must have chained in C, and
every run but phase 15's plain turn must call no plain loop.
Every launch count is set to 0 just before a run of the main path and read
just after. Each kernel's bound is the larger of the bytes its inputs need
(each byte once, a block row once however many entries read it) over
3.35 TB/s and its integer operations over 33.5 TOP/s (int32 runs on
half the lanes of the card's 67 TFLOP/s float32 rate); for kernels 4-6 the
bytes count each 32-byte O2 sector the run's steps need once. Then a JSON
line of kernel results, and last
{"ok": true, "device": {"platform": "gpu", ...}}.

Usage: python3 chip_smoke.py [--pairs N] [--host-pairs N] [--genome-bp N]
                             [--seed S] [--traced-pairs N] [--long-reads N]
       python3 chip_smoke.py --fwd-turns DIR [DIR ...] [--genome-bp N]
       python3 chip_smoke.py --sa-turns DIR [DIR ...] [--genome-bp N]
       python3 chip_smoke.py --v8-turns [DIR ...] [--genome-bp N]
(--host-pairs sets the pairs of phases 6, 7, 12 and 13. --fwd-turns times
kernels 4 and 5 against the fwd_automata.cu of each DIR, --sa-turns kernel
6 against the sa_walk.cu of each DIR, --v8-turns kernel 7 against the
bwd_v8.cu of each DIR (after step 0's counts), with the o2.cuh beside
it, in turns on the same inputs, and runs no other phase: see fwd_turns,
sa_turns, v8_turns.)
Exits non-zero without a usable CUDA device, on any mismatch and on any
error.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import os
import re
import signal
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
    # the JAX package's device loops: XLA while_loops, not Pallas kernels
    "forward_p3": {"name": "forward_p3", "route": "cuda",
                   "source": "mpibwa_tpu_torch/csrc/fwd_automata.cu",
                   "replaces": "mpibwa_tpu/ops/seeding.py:478",
                   "replaces_what": "the XLA while_loop of forward_p3 (not "
                                    "a Pallas kernel)"},
    "forward_pass": {"name": "forward_pass", "route": "cuda",
                     "source": "mpibwa_tpu_torch/csrc/fwd_automata.cu",
                     "replaces": "mpibwa_tpu/ops/seeding.py:227",
                     "replaces_what": "the XLA while_loop of forward_pass "
                                      "(not a Pallas kernel)"},
    "sa_walk": {"name": "sa_walk", "route": "cuda",
                "source": "mpibwa_tpu_torch/csrc/sa_walk.cu",
                "replaces": "mpibwa_tpu/ops/fmd.py:589",
                "replaces_what": "the XLA while_loop of _sa_lookup16 (not a "
                                 "Pallas kernel)"},
    "bwd_v8": {"name": "bwd_v8", "route": "cuda",
               "source": "mpibwa_tpu_torch/csrc/bwd_v8.cu",
               "replaces": "mpibwa_tpu/ops/backward8.py:211",
               "replaces_what": "the XLA loop of the v8 engine, _round8 "
                                "driven by run_backward8 (not a Pallas "
                                "kernel)"},
}
# the sources to build (csrc/<name>.cu), one nvcc each
SOURCES = sorted({os.path.basename(k["source"])[:-3]
                  for k in KERNELS.values()})
# each kernel's name in a profiler trace (csrc/*.cu)
SYMBOLS = {"extend": "extend_kernel<", "occ4_extend": "occ4_extend_kernel",
           "bwd_pass": "bwd_pass_kernel<",
           "forward_p3": "forward_p3_kernel<",
           "forward_pass": "forward_pass_kernel<",
           "sa_walk": "sa_walk_kernel<", "bwd_v8": "bwd_v8_kernel<"}
# the kernels every default run of the main path launches
MAIN_KERNELS = ("extend", "bwd_pass", "forward_p3", "forward_pass",
                "sa_walk")
LOOP_KERNELS = ("forward_p3", "forward_pass", "sa_walk")
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
# integer operations of one forward extension through O2 (csrc/o2.cuh):
# four ranks of about 12 (mask, select, popcount, correction), two
# positions of about 6 and about 40 of interval arithmetic and the
# automaton's bookkeeping; of one SA walk step, one rank, the base and
# about 15 more
OPS_PER_O2_STEP = 4 * 12 + 2 * 6 + 40
OPS_PER_SA_STEP = 12 + 6 + 8 + 15
# of one step of the v8 kernel (a live entry's round with a query base):
# two ranks of about 12, two positions of about 6 and about 15 of interval
# arithmetic and the entry's update
OPS_PER_V8_STEP = 2 * 12 + 2 * 6 + 15
SECTOR = 32  # bytes of one O2 sub-block (4 rows of 8 B), read as a unit
# every Q and T bucket of DeviceAligner.Q_BUCKETS / T_BUCKETS
BUCKETS = [(64, 128), (128, 256), (192, 384), (256, 512), (512, 768),
           (512, 1024)]
PEN = (6, 1, 6, 1)  # bwa-mem's default gap open/extend, del and ins
SIDE = []  # side processes (start_plain_wide), stopped when main returns
SIDE_WAIT_S = 600  # the longest phase 2g waits for the side process


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


def host_ms(fn, reps: int) -> float:
    """The host's wall time of fn, which queues work on the card and need
    not wait for it: the median of reps calls, each after the card is
    idle, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


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
    names = SOURCES
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
    backward pass through the pass kernel for phase 2d, the forward
    automata's inputs, pass 2's first call and the first SA walk of a run
    tagged for capture (phase 2g), and the batch size of every wrapper call
    that launches a kernel. The launch counts stay on the wrappers
    themselves. It counts every call of the three loops' plain versions
    (ops/seeding.forward_p3, forward_pass, ops/fmd._sa_lookup16): a main-path
    run makes none. With ``plain`` set, the seeder's calls of the three
    loop kernels go to those plain versions instead (phase 15); with
    ``time_sa`` set, each SA walk is timed between two synchronizes."""

    def __init__(self):
        from mpibwa_tpu_torch.ops import (bwd_cuda, extend_cuda, fmd,
                                          fwd_cuda, occ4_cuda, sa_cuda,
                                          seeding, v8_cuda)
        from mpibwa_tpu_torch.parallel.runtime import Runtime
        from mpibwa_tpu_torch.pipeline import device_seed
        from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

        self.runtimes = []
        self.fwd_calls = {}  # capture tag -> forward_p3 arguments
        self.p2_call = None  # the first pass-2 forward_pass arguments
        self.sa_ks = None  # the first SA walk's indices
        self.v8_calls = []  # the first two v8 passes of a run tagged "11"
        self.capture = None  # the tag of the run being captured
        self.plain = False
        self.time_sa = False
        self.sa_s = 0.0
        self.sa_calls = 0
        self.plain_calls = 0
        self.captured = []
        self.occ4_ik = None
        self.bwd_call = None
        self.rows_call = None
        self.sizes = {name: [] for name in KERNELS}
        self.pass_widths = []  # query-row width of every pass launch
        self.word_dtypes = []  # dtype of every pass-1 call-word tensor
        self._lock = threading.Lock()
        self._mods = (extend_cuda, occ4_cuda, bwd_cuda, fwd_cuda, sa_cuda,
                      seeding, fmd, v8_cuda)
        self._real_loops = (fwd_cuda.forward_p3_kernel,
                            fwd_cuda.forward_pass_kernel,
                            sa_cuda.sa_walk_kernel)
        self._plain = (seeding.forward_p3, seeding.forward_pass,
                       fmd._sa_lookup16)
        self._real = extend_cuda.extend_batch_kernel
        self._real_occ4 = occ4_cuda.extend_kernel
        self._real_bwd = bwd_cuda.run_backward_fused
        self._real_pass = bwd_cuda.bwd_pass_kernel
        self._real_v8 = v8_cuda.v8_pass_kernel
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

        def v8_pass(fm, qrows, entry, n_lanes, x0, minv, **k):
            with spy._lock:
                if spy.capture == "11" and len(spy.v8_calls) < 2:
                    spy.v8_calls.append(v8_capture(fm, qrows, entry,
                                                   n_lanes, x0, minv, k))
            return sized("bwd_v8", lambda *a: spy._real_v8(*a, **k),
                         entry[0].shape[0], fm, qrows, entry, n_lanes, x0,
                         minv)

        def words(*a):
            out = spy._real_words(*a)
            with spy._lock:
                spy.word_dtypes.append(out.dtype)
            return out

        def counted(real):
            def plain(*a, **k):
                with spy._lock:
                    spy.plain_calls += 1
                return real(*a, **k)
            return plain

        def forward_p3(fm, q, lens, minv, msl, max_intv):
            with spy._lock:
                got = spy.fwd_calls.get(spy.capture)
                if spy.capture and (got is None
                                    or q.shape[1] > got[0].shape[1]):
                    spy.fwd_calls[spy.capture] = (q.clone(), lens.clone(),
                                                  minv.clone())
            if spy.plain:
                return seeding.forward_p3(fm, q, lens, minv, msl, max_intv)
            return sized("forward_p3", spy._real_loops[0], q.shape[0], fm,
                         q, lens, minv, msl, max_intv)

        def forward_pass(fm, q, lens, minv, chain=True, starts=None):
            with spy._lock:
                if spy.capture == "4" and not chain and spy.p2_call is None:
                    spy.p2_call = (q.clone(), lens.clone(), minv.clone(),
                                   starts.clone())
            if spy.plain:
                return seeding.forward_pass(fm, q, lens, minv, chain, starts)
            return sized("forward_pass", spy._real_loops[1], q.shape[0], fm,
                         q, lens, minv, chain, starts)

        def sa_walk(fm, ks):
            with spy._lock:
                if spy.capture == "4" and spy.sa_ks is None:
                    spy.sa_ks = ks.clone()
                spy.sa_calls += 1
            if spy.time_sa:
                torch.cuda.synchronize()
                t = time.perf_counter()
            if spy.plain:
                out = fmd._sa_lookup16(fm.o2_tables(), fm.L2, fm.primary,
                                       fm.seq_len, fm.sa, fm.sa_intv, ks)
            else:
                out = sized("sa_walk", spy._real_loops[2], ks.shape[0], fm,
                            ks)
            if spy.time_sa:
                torch.cuda.synchronize()
                with spy._lock:
                    spy.sa_s += time.perf_counter() - t
            return out

        Runtime.__init__ = rt_init
        extend_cuda.extend_batch_kernel = capture
        occ4_cuda.extend_kernel = capture_occ4
        bwd_cuda.run_backward_fused = capture_bwd
        bwd_cuda.bwd_pass_kernel = size_pass
        v8_cuda.v8_pass_kernel = v8_pass
        DeviceSeeder._backward_rows = capture_rows
        device_seed.pack_call_words = words
        seeding.forward_p3, seeding.forward_pass, fmd._sa_lookup16 = (
            counted(f) for f in self._plain)
        fwd_cuda.forward_p3_kernel = forward_p3
        fwd_cuda.forward_pass_kernel = forward_pass
        sa_cuda.sa_walk_kernel = sa_walk

    @staticmethod
    def kernel_wrappers() -> dict:
        """Each kernel's wrapper, which counts its launches."""
        from mpibwa_tpu_torch.ops import (bwd_cuda, extend_cuda, fwd_cuda,
                                          occ4_cuda, sa_cuda, v8_cuda)

        return {"extend": extend_cuda.extend_batch_kernel,
                "occ4_extend": occ4_cuda.extend_kernel,
                "bwd_pass": bwd_cuda.bwd_pass_kernel,
                "forward_p3": fwd_cuda.forward_p3_kernel,
                "forward_pass": fwd_cuda.forward_pass_kernel,
                "sa_walk": sa_cuda.sa_walk_kernel,
                "bwd_v8": v8_cuda.v8_pass_kernel}

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
        (extend_cuda, occ4_cuda, bwd_cuda, fwd_cuda, sa_cuda, seeding,
         fmd, v8_cuda) = self._mods
        extend_cuda.extend_batch_kernel = self._real
        occ4_cuda.extend_kernel = self._real_occ4
        bwd_cuda.run_backward_fused = self._real_bwd
        bwd_cuda.bwd_pass_kernel = self._real_pass
        v8_cuda.v8_pass_kernel = self._real_v8
        (fwd_cuda.forward_p3_kernel, fwd_cuda.forward_pass_kernel,
         sa_cuda.sa_walk_kernel) = self._real_loops
        seeding.forward_p3, seeding.forward_pass, fmd._sa_lookup16 = \
            self._plain

    def reset(self):
        for fn in self.wrappers.values():
            fn.launches = 0
        for sizes in self.sizes.values():
            sizes.clear()
        self.runtimes.clear()
        self.pass_widths.clear()
        self.word_dtypes.clear()
        self.sa_s = 0.0
        self.sa_calls = 0
        self.plain_calls = 0


def run_cli(workdir: str, argv: "list[str]", spy: Spy, ext: str,
            knobs: "dict | None" = None, capture: "str | None" = None
            ) -> dict:
    """`cli mem` in workdir with -o out; returns its SAM bytes and stats.
    knobs: environment variables for this run only (MPIBWA_PALLAS and
    MPIBWA_BWD are unset otherwise: the defaults); capture: the tag under
    which the spy keeps the run's forward inputs. Unless the spy routes
    the loops to their plain versions, the run must not call them."""
    from mpibwa_tpu_torch import cli

    os.makedirs(workdir, exist_ok=True)
    os.environ["MPIBWA_EXT"] = ext
    for k in ("MPIBWA_PALLAS", "MPIBWA_BWD"):
        os.environ.pop(k, None)
    os.environ.update(knobs or {})
    cwd = os.getcwd()
    os.chdir(workdir)
    spy.reset()
    spy.capture = capture
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
        spy.capture = None
        os.chdir(cwd)
        for k in knobs or {}:
            os.environ.pop(k, None)
    if spy.plain_calls and not spy.plain:
        raise Failed(f"the main path called a plain loop "
                     f"{spy.plain_calls} times")
    with open(os.path.join(workdir, "out.sam"), "rb") as fh:
        sam = fh.read()
    return {"sam": sam, "wall": wall, "align": rt.times["align"],
            "chained_in_c": chained_in_c,
            "launches": spy.launches, "stats": al.stats,
            "seed_times": al.seeder.times,
            "peak": torch.cuda.max_memory_allocated(),
            "sizes": spy.size_hist(), "sa_s": spy.sa_s,
            "sa_calls": spy.sa_calls, "plain_calls": spy.plain_calls}


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
    mems_k = BC.pull_rows(BC.pack_emitted(kst, entry[1], lanes.lane_e), E)[0]
    mems_p = BC.pull_rows(BC.pack_emitted(want, entry[1], lanes.lane_e),
                          E)[0]
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


@contextlib.contextmanager
def plain_v8():
    """A context in which the seeder's v8 passes run the plain torch v8
    (ops/backward8.run_backward8) on the card instead of kernel 7 (the
    wrapper's module attribute patched, no knob); yields a dict counting
    the plain passes."""
    from mpibwa_tpu_torch.ops import backward8 as B8
    from mpibwa_tpu_torch.ops import v8_cuda

    real, calls = v8_cuda.v8_pass_kernel, {"passes": 0}

    def plain(fm, qrows, entry, n_lanes, x0, minv, max_len=None, **k):
        calls["passes"] += 1
        return B8.run_backward8(fm, qrows, entry, n_lanes, x0, minv, **k)

    v8_cuda.v8_pass_kernel = plain
    try:
        yield calls
    finally:
        v8_cuda.v8_pass_kernel = real


def phase2e(ref: str, fm32, reads):
    """The int64 position path on the phase 3 genome: collect_flat under v8
    (each pass one launch of kernel 7) == the plain torch v8 (all three
    arrays) on both indexes, v8 on the int64 index == v8 on the int32 one,
    flat and contig == v8 on (x0, x2, info), the offsets and the fallback
    flags; every run timed in turns (medians of 3 after a warm-up) with
    peak device memory, the kernels' launches and each seeder's stages.
    Returns the int64 index (phases 2g, 2i)."""
    from mpibwa_tpu_torch.core.opts import mem_opt_init
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    t0 = time.time()
    wide = DeviceFMIndex(host_index(ref), fm32.device, force_wide=True)
    torch.cuda.synchronize()
    log(f"phase 2e int64 index (force_wide) of the phase 3 genome on the "
        f"card in {time.time() - t0:.1f} s")
    qs = [s.seq for s in reads]
    keys = (("v8", wide), ("v8 plain", wide), ("flat", wide),
            ("contig", wide), ("v8 int32", fm32), ("v8 plain int32", fm32))
    seeders = {k: DeviceSeeder(fm, mem_opt_init()) for k, fm in keys}
    plain_passes = {k: 0 for k in seeders}

    def run(key):
        os.environ["MPIBWA_BWD"] = key.split()[0]
        try:
            with (plain_v8() if "plain" in key
                  else contextlib.nullcontext()) as calls:
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = seeders[key].collect_flat(qs)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
            if calls:
                plain_passes[key] += calls["passes"]
        finally:
            os.environ.pop("MPIBWA_BWD", None)
        if out is None:
            raise Failed(f"phase 2e: collect_flat under {key} overflowed")
        return out, dt

    wrappers = Spy.kernel_wrappers()
    n0 = {k: fn.launches for k, fn in wrappers.items()}
    out = {k: run(k)[0] for k in seeders}  # the warm-up
    launched = {k: fn.launches - n0[k] for k, fn in wrappers.items()}

    def same(x, y, cols=None):
        if cols is not None:
            return (np.array_equal(x[0][:, cols], y[0][:, cols])
                    and np.array_equal(x[1], y[1])
                    and np.array_equal(x[2], y[2]))
        return all(np.array_equal(a, b) for a, b in zip(x, y))

    a = out["v8"]
    checks = {"v8 int64 == the plain v8 int64 (all three arrays)":
              same(a, out["v8 plain"]),
              "v8 int32 == the plain v8 int32 (all three arrays)":
              same(out["v8 int32"], out["v8 plain int32"]),
              "v8 int64 == v8 int32 (all three arrays)":
              same(a, out["v8 int32"]),
              "flat int64 == v8 int64 on (x0, x2, info), offsets and "
              "fallback": same(a, out["flat"], [0, 2, 3]),
              "contig int64 == v8 int64 on the same":
              same(a, out["contig"], [0, 2, 3])}
    log(f"phase 2e {len(qs)} reads, {len(a[0])} seed rows, "
        f"{int(a[2].sum())} reads to the host engine: "
        + "; ".join(f"{k}: {v}" for k, v in checks.items())
        + f"; kernel launches over the warm-up {launched}; plain v8 passes "
        f"{plain_passes}")
    if not all(checks.values()):
        raise Failed("phase 2e: the int64 path disagrees")
    if launched["bwd_v8"] <= 0 or not all(
            plain_passes[k] for k in ("v8 plain", "v8 plain int32")):
        raise Failed("phase 2e: kernel 7 or the plain v8 did not run")
    times = {k: [] for k in seeders}
    peak = {k: 0 for k in times}
    for _ in range(3):
        for key in times:
            torch.cuda.reset_peak_memory_stats()
            got, dt = run(key)
            peak[key] = max(peak[key], torch.cuda.max_memory_allocated())
            times[key].append(dt)
            if not same(got, out[key]):
                raise Failed(f"phase 2e: {key} changed between runs")
    for tag, k, p in (("int64", "v8", "v8 plain"),
                      ("int32", "v8 int32", "v8 plain int32")):
        beats = all(x < y for x, y in zip(times[k], times[p]))
        log(f"phase 2e {tag}: collect_flat with kernel 7 "
            f"{'beats' if beats else 'does not beat'} the plain torch v8 in "
            f"every turn: medians {np.median(times[k]):.3f} / "
            f"{np.median(times[p]):.3f} s")
    for key in times:
        st = {k: round(v, 3) if isinstance(v, float) else v
              for k, v in seeders[key].times.items()}
        log(f"phase 2e {key}: collect_flat {np.median(times[key]):.3f} s "
            f"(median of 3 after a warm-up, in turns; "
            f"{', '.join(f'{t:.3f}' for t in times[key])}); peak device "
            f"memory {peak[key] / 2**30:.3f} GiB (both indexes resident); "
            f"over its 4 runs: {st}")
    return wide


INPROC_PAIRS = 16_384  # phase 2i: the first pairs of phase 4's input


def v8_capture(fm, qrows, entry, n_lanes, x0, minv, kw) -> tuple:
    """A v8 pass's arguments, copied: (fm, qrows, entries, n_lanes, x0,
    minv, min_len, max_len, est_rows)."""
    def cp(a):
        return a.clone() if isinstance(a, torch.Tensor) else np.array(a)

    return (fm, qrows.clone(), tuple(t.clone() for t in entry), n_lanes,
            cp(x0), cp(minv), kw.get("min_len", 0), kw.get("max_len"),
            kw.get("est_rows", 0))


def phase2i(work, ref, fm32, fm64, paths, smi) -> tuple:
    """The int64 main path end to end, in process, with no knob: the
    aligner that the CLI's Runtime builds (DeviceAligner) sharing phase
    2e's int64 index (dfm=fm64), and once more sharing the int32 index
    (dfm=fm32), under a Runtime at `mem -t 1`'s chunk size, on the first
    INPROC_PAIRS pairs of phase 4's input: byte-identical SAM; on the int64
    index every backward pass is a launch of kernel 7 (MPIBWA_BWD=auto) and
    the pass kernel never launches, on the int32 index the reverse. Returns
    the int64 run's first v8 pass (v8_capture) for phase 2g and kernel 7's
    launches in the int64 run."""
    from mpibwa_tpu_torch.core.fm import FMIndex
    from mpibwa_tpu_torch.core.refseq import RefSeq
    from mpibwa_tpu_torch.io import headers as hdr
    from mpibwa_tpu_torch.ops import v8_cuda
    from mpibwa_tpu_torch.parallel.runtime import Runtime
    from mpibwa_tpu_torch.pipeline.device_align import DeviceAligner

    idx = host_index(ref)
    fm_host, refs = FMIndex.from_index(idx), RefSeq(idx)
    argv = ["-t", "1", "-o", "out", ref, paths["i1"], paths["i2"]]
    real, got = v8_cuda.v8_pass_kernel, []

    def capture(fm, qrows, entry, n_lanes, x0, minv, **k):
        if not got:
            got.append(v8_capture(fm, qrows, entry, n_lanes, x0, minv, k))
        return real(fm, qrows, entry, n_lanes, x0, minv, **k)

    sams, runs = {}, {}
    for tag, dfm in (("int32", fm32), ("int64", fm64)):
        opt = cli_opt()
        rt = Runtime(idx, opt, use_device=False,
                     fixed_chunk_size=opt.chunk_size * opt.n_threads,
                     verbose=False)
        al = DeviceAligner(idx, opt, dfm=dfm, fm=fm_host, refs=refs)
        rt.aligners = [al]
        out = os.path.join(work, f"inproc_{tag}")
        wrappers = Spy.kernel_wrappers()
        n0 = {k: fn.launches for k, fn in wrappers.items()}
        os.environ.pop("MPIBWA_BWD", None)
        v8_cuda.v8_pass_kernel = capture
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            rt.run(paths["i1"], paths["i2"], out,
                   pg_line=hdr.make_pg_line(["mpibwa-tpu", "mem"] + argv))
            torch.cuda.synchronize()
        finally:
            v8_cuda.v8_pass_kernel = real
        wall = time.perf_counter() - t
        n = {k: fn.launches - n0[k] for k, fn in wrappers.items()}
        with open(out + ".sam", "rb") as fh:
            sams[tag] = fh.read()
        st = {k: round(v, 3) if isinstance(v, float) else v
              for k, v in al.seeder.times.items()}
        runs[tag] = n
        log(f"phase 2i in-process DeviceAligner over the {tag} index "
            f"({dfm.idt}) on {smi}: {2 * INPROC_PAIRS} reads in "
            f"{rt.times['align']:.2f} s aligning "
            f"({2 * INPROC_PAIRS / rt.times['align']:.1f} reads/s), "
            f"{wall:.2f} s wall; kernel launches {n}; seeder {st}")
    same = sams["int32"] == sams["int64"]
    log(f"phase 2i SAM of the int64 index == the int32 index's: {same} "
        f"({len(sams['int64'])} bytes)")
    if not same:
        raise Failed("phase 2i: the int64 main path's SAM differs")
    if (runs["int64"]["bwd_v8"] <= 0 or runs["int64"]["bwd_pass"]
            or runs["int32"]["bwd_v8"] or runs["int32"]["bwd_pass"] <= 0):
        raise Failed(f"phase 2i: the backward kernels launched {runs}")
    check_sam(sams["int64"], 2 * INPROC_PAIRS)
    return got[0], runs["int64"]["bwd_v8"]


def rows_err(got: np.ndarray, want: np.ndarray) -> int:
    """Max abs difference of two row arrays; the difference of their row
    counts where those differ."""
    if got.shape != want.shape:
        return max(1, abs(len(got) - len(want)))
    if not len(got):
        return 0
    return int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())


def v8_trace(fm, inp) -> dict:
    """What a v8 pass needs, for a bound and for kernel 7's layout: the
    rounds of its longest lane and each lane's rounds (a round of a lane
    that starts with a live entry), its steps (a live entry's round with a
    query base, two ranks each), the steps whose (lane, k0, s) is
    distinct in their round, the sector loads of the steps (one, or two
    where the two positions lie in different sub-blocks), the distinct O2
    sectors those ranks read, the query bytes read (a lane's live entries
    share their i, so one byte a lane a round while the lane has a live
    entry inside its row), and every entry's final k0, s, i and flags (the
    kernel's outputs of the entries in lanes), from the v8 rule run in
    torch over the flat state on the card, lane by lane in lockstep (inp:
    v8_cuda.V8Inputs; one host read a round, a trace and not a timed
    run)."""
    from mpibwa_tpu_torch.ops.backward8 import _occ_c2

    L = inp.q.shape[1]
    dev = inp.ik.device
    off = inp.lane_off.long()
    E = int(off[-1])  # the entries in lanes
    lane = torch.searchsorted(off[1:].contiguous(),
                              torch.arange(E, device=dev), right=True)
    qflat = inp.q.reshape(-1)
    k0, s = inp.ik[:E, 0].clone(), inp.ik[:E, 2].to(torch.int32)
    i = inp.x0[lane] - 1
    minv, live = inp.minv[lane], inp.live[:E].clone()
    bound = torch.zeros(E, dtype=torch.bool, device=dev)
    bound[off[:-1][off[:-1] < off[1:]]] = True
    emitted = torch.zeros_like(bound)
    l2 = fm.L2[:4]
    lane_rounds = torch.zeros(len(off) - 1, dtype=torch.int64, device=dev)
    rounds = steps = qbytes = distinct = loads = 0
    blocks = []
    while bool(live.any()):
        started = torch.zeros_like(lane_rounds, dtype=torch.bool)
        started[lane[live]] = True
        lane_rounds += started
        valid = (i >= 0) & (i < L)
        qbytes += int(torch.unique(lane[live & valid]).numel())
        qi = torch.where(valid, qflat[lane * L + i.clamp(0, L - 1).long()]
                         .to(torch.int32), 4)
        need = live & (qi < 4)
        c = qi.clamp(max=3)
        kq = k0 - 1
        t = _occ_c2(fm.o2_tables(), fm.primary, torch.cat([kq, kq + s]),
                    torch.cat([c, c]))
        tk, s2 = t[:E], t[E:] - t[:E]
        sb = []
        for pos in (kq[need], (kq + s)[need]):
            p = pos.clamp(min=0)
            sb.append((p - (p >= fm.primary).to(p.dtype)) >> 4)
            blocks.append(torch.unique(sb[-1]))
        steps += int(need.sum())
        loads += int(need.sum()) + int((sb[0] != sb[1]).sum())
        distinct += torch.unique(torch.stack(
            [lane[need], k0[need].long(), s[need].long()]), dim=1).shape[1]
        keeper = need & (s2 >= minv)
        emitted |= live & (bound | ~torch.cat([live.new_zeros(1),
                                               live[:-1]])) & ~keeper
        k0 = torch.where(keeper, l2[c.long()] + 1 + tk, k0)
        s = torch.where(keeper, s2, s)
        i = torch.where(keeper, i - 1, i)
        live = keeper
        rounds += 1
    sectors = (int(torch.unique(torch.cat(blocks)).numel()) if blocks
               else 0)
    return {"rounds": rounds, "steps": steps, "sectors": sectors,
            "qbytes": qbytes, "distinct": distinct, "loads": loads,
            "lane_rounds": lane_rounds,
            "final": {"k0": k0, "s": s, "i": i,
                      "flags": emitted.to(torch.uint8) * 2}}


LENGTH_BINS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 192)  # bin upper edges
# step 0's packed layout without compaction: the threads of a lane's run
# by its entries (clamped to 33), the next power of two up to a warp, a
# whole warp past 32 entries; runs sorted by size and x0, both down, so
# every run lies in one warp
RUN = (0, 1, 2, 4, 4) + (8,) * 4 + (16,) * 8 + (32,) * 17


def v8_counts(tag: str, inp, tr: dict, rate: float) -> dict:
    """Step 0 of kernel 7's layout on one pass (inp: v8_cuda.V8Inputs, tr:
    its v8_trace): the lanes by entry count; the warp-rounds of one warp
    a lane (each lane's rounds, summed), of the packed layout (RUN's
    runs, no compaction: a warp runs until its last lane ends) and of its
    lanes past 32 entries (a round of such a lane walks its chunks one
    after another: its rounds times its chunks); the steps, the distinct
    steps, and the live-thread share (steps over 32 threads a warp-round);
    whether distinct steps / 32 fall under half the packed warp-rounds
    (the test for compacting dead and duplicate entries); the random-load
    floor (the steps' sector loads at the probe's full-card rate, rate a
    second). Logs them; returns the numbers."""
    off = inp.lane_off.long()
    n = off[1:] - off[:-1]
    lr = tr["lane_rounds"]
    size = torch.tensor(RUN, device=n.device)[n.clamp(max=len(RUN) - 1)]
    o = torch.sort(size * 2**32 + inp.x0, descending=True).indices
    size = size[o]
    ends = torch.cumsum(size, 0)
    ns, lrs = n[o], lr[o]
    short = (size > 0) & (ns <= 32)
    packed = torch.zeros(len(n), dtype=torch.int64, device=n.device)
    packed.scatter_reduce_(0, ((ends - size) // 32)[short], lrs[short],
                           "amax")
    lng = ns > 32
    c = {"lanes": int((n > 0).sum()), "lanes_launched": len(n),
         "lanes_over_32": int(lng.sum()),
         "entries_over_32": int(ns[lng].sum()),
         "rounds_over_32": int(lrs[lng].max()) if bool(lng.any()) else 0,
         "longest_lane": int(n.max()),
         "warps_packed": (int(ends[-1]) + 31) // 32,
         "warp_rounds_one_a_lane": int(lr.sum()),
         "warp_rounds_packed": int(packed.sum()),
         "chunk_rounds_over_32": int((lrs * ((ns + 31) // 32))[lng].sum()),
         "steps": tr["steps"], "distinct_steps": tr["distinct"],
         "sector_loads": tr["loads"]}
    hist, lo = {}, -1
    for hi in LENGTH_BINS:
        hist[f"{lo + 1}-{hi}" if hi > lo + 1 else str(hi)] = int(
            ((n > lo) & (n <= hi)).sum())
        lo = hi
    hist[f">{lo}"] = int((n > lo).sum())
    c["histogram"] = hist
    wr = c["warp_rounds_packed"] + c["chunk_rounds_over_32"]
    c["live_share_one_a_lane"] = tr["steps"] / max(
        32 * c["warp_rounds_one_a_lane"], 1)
    c["live_share_packed"] = tr["steps"] / max(32 * wr, 1)
    c["compact"] = c["distinct_steps"] / 32 < wr / 2
    c["random_load_floor_ms"] = tr["loads"] / rate * 1e3
    log(f"step 0 of kernel 7 on {tag}: {json.dumps(c)} (compaction "
        f"{'called for' if c['compact'] else 'not called for'}: distinct "
        f"steps / 32 = {c['distinct_steps'] / 32:.1f} against the packed "
        f"layout's {wr} warp-rounds; random-load floor "
        f"{c['random_load_floor_ms']:.5f} ms: {tr['loads']} sector loads at "
        f"{rate / 1e9:.3f} G a second)")
    return c


def warps_per_sm(regs: int, block: int = 128) -> int:
    """Resident warps an SM of the H100 holds for a kernel of `regs`
    registers a thread in blocks of `block` threads, by registers alone:
    65,536 registers, allocated a warp at a time in units of 256, at most
    64 warps and 32 blocks."""
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(65536 // (per_warp * (block // 32)), 32)
    return min(blocks * block // 32, 64)


def v8_case(tag, call, floor, ptype, rate) -> dict:
    """Kernel 7 on a captured main-path pass against the plain torch v8 on
    the card (rows in lane order, every column equal), one launch of the
    wrapper, and entry by entry against v8_trace's final state (k0, s, i
    and flags of every entry in a lane); step 0's counts (v8_counts) with
    the kernel's own warp-rounds (ctl[3] of one launch) and live-thread
    share beside them; the kernel alone
    timed (20 launches back to back into the same outputs: its inputs are
    read-only, every output slot is written and the lane counters are
    0 again after a launch, so each launch starts from the same state),
    with the L2 flushed, the wrapper's call (its pull included) and the
    plain version (CUDA events, medians); its bound, latency floor and
    random-load floor (rate: the probe's loads a second)."""
    from mpibwa_tpu_torch.ops import backward8 as B8
    from mpibwa_tpu_torch.ops import v8_cuda as V

    fm, qrows, entry, NL, x0, minv, min_len, max_len, est = call
    E = entry[0].shape[0]
    n0 = V.v8_pass_kernel.launches
    got, ov = V.v8_pass_kernel(fm, qrows, entry, NL, x0, minv,
                               min_len=min_len, raw=True, est_rows=est,
                               max_len=max_len)
    torch.cuda.synchronize()
    if V.v8_pass_kernel.launches != n0 + 1:
        raise Failed("phase 2g: bwd_v8 took other than one launch")
    want, pov = B8.run_backward8(fm, qrows, entry, NL, x0, minv,
                                 min_len=min_len, raw=True, est_rows=est)
    err = rows_err(got, V.lane_order(want))
    if ov or pov:
        raise Failed(f"phase 2g: bwd_v8 {tag} overflowed (kernel {ov}, "
                     f"plain {pov})")
    inp = V.v8_inputs(fm, qrows, entry, NL, x0, minv)
    out = V.v8_outputs(fm, E, qrows.device)

    def go():
        if V.v8_launch(fm, inp, out) != 0:
            raise Failed("a timing launch of bwd_v8 failed")
    go.keep = (inp.q,)
    go()
    torch.cuda.synchronize()
    ctl = out.ctl.tolist()
    tr = v8_trace(fm, inp)
    used = int(inp.lane_off[-1])  # the entries in lanes (v8_inputs)
    err_entries = max(max_err(getattr(out, k)[:used], v)
                      for k, v in tr["final"].items())
    counts = v8_counts(tag, inp, tr, rate)
    ms, cold = launch_ms(go, 20), cold_ms(go)
    call_ms = median_ms(lambda: V.v8_pass_kernel(
        fm, qrows, entry, NL, x0, minv, min_len=min_len, raw=True,
        est_rows=est, max_len=max_len), 5)
    plain_ms = median_ms(lambda: B8.run_backward8(
        fm, qrows, entry, NL, x0, minv, min_len=min_len, raw=True,
        est_rows=est), 3)
    rounds = ctl[0]
    if rounds != tr["rounds"] or ctl[1] or ctl[2]:
        raise Failed(f"phase 2g: bwd_v8 ran {rounds} rounds, its trace "
                     f"{tr['rounds']}; its lane counters {ctl[1:3]}")
    pos = entry[0].element_size()
    L = qrows.shape[1]
    n_live = int(entry[3].sum())  # all in lanes
    # what the pass must move, once each: every entry in a lane its live
    # flag and its outputs (k0, s, i, flags), a live one also the x[0] and
    # x[2] it starts from (x[1] is never read); every lane that holds an
    # entry its offset, x0 and min_intv; the query bytes its live entries
    # read (v8_trace); each O2 sector the ranks read
    nbytes = (used * (1 + pos + 9) + n_live * 2 * pos + counts["lanes"] * 12
              + tr["qbytes"] + SECTOR * tr["sectors"])
    ops = OPS_PER_V8_STEP * tr["steps"]
    b_ms, b_by = bound(nbytes, ops)
    live_share = tr["steps"] / max(32 * ctl[3], 1)
    log(f"phase 2g bwd_v8 {tag} (E={E}, {used} in lanes, {n_live} live "
        f"entries in {counts['lanes']} lanes of {NL}, L={L}, {ptype}, "
        f"min_len {min_len}): max_abs_err={err} over the {len(got)} rows "
        f"against the plain v8 in lane order, {err_entries} over the "
        f"{used} entries' outputs against the trace; {rounds} rounds (the "
        f"longest lane), {tr['steps']} steps, {tr['sectors']} distinct O2 "
        f"sectors, {tr['qbytes']} query bytes read; the kernel's warps ran "
        f"{ctl[3]} warp-rounds (one warp a lane: "
        f"{counts['warp_rounds_one_a_lane']}), live-thread share "
        f"{live_share:.4f} (one warp a lane: "
        f"{counts['live_share_one_a_lane']:.4f}); kernel "
        f"{ms:.4f} ms (20 launches back to back, median of 3), {cold:.4f} ms "
        f"with the L2 flushed (one launch, median of 11), the wrapper's "
        f"call with the rows' compaction and pull (est_rows {est}) "
        f"{call_ms:.4f} ms (median of 5), plain {plain_ms:.2f} ms (median "
        f"of 3), CUDA events; bound "
        f"{b_ms:.5f} ms by {b_by} ({nbytes} B, {ops} operations), "
        f"{b_ms / ms:.4f} of the kernel's time; "
        f"{floor(ms, rounds, tr['loads'])}; "
        f"{ms * 1e3 / max(rounds, 1):.3f} us a round")
    return {"ms": ms, "cold_ms": cold, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "rounds": rounds, "max_abs_err": max(err, err_entries),
            "warp_rounds": ctl[3], "live_thread_share": live_share,
            "random_load_floor_ms": counts["random_load_floor_ms"]}


BIG_SEQ_LEN = 2**31 + 2**24  # phase 2h: positions of the rank table
# phase 2h: the table's base shares; T so rare that L2[3] > 2**31 (every
# interval of a T lies above 2**31, and ranks at x[1] of an A start there)
BIG_BASES = (0.45, 0.27, 0.275, 0.005)
BIG_READS = 4_096  # phase 2h: 101-bp reads, A-rich (READ_BASES)
READ_BASES = (0.55, 0.15, 0.15, 0.15)
BIG_CHUNK = 1 << 24  # words a chunk while the table is built on the card


def big_table(dev, seed: int, seq_len: int) -> dict:
    """Phase 2h's rank table as DeviceFMIndex.from_numpy's state: seq_len
    random bases (shares BIG_BASES, from a torch generator on the card at
    seed), packed 16 to a word MSB-first as the O2 table holds them; row
    sb * 4 + c = [occ_c before sub-block sb, word sb], the counts
    cumulative and consistent (int32), L2 their totals, primary a third of
    the way in. Built on the card in chunks of BIG_CHUNK words and pulled
    into one host array. It is a rank table, not a BWT: the SA and the
    packed reference are stubs."""
    n_words = seq_len // 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cuts = [int(c * 65536) for c in np.cumsum(BIG_BASES)[:3]]
    shift = torch.arange(30, -1, -2, dtype=torch.int64, device=dev)
    o2 = np.empty((4 * n_words, 2), np.int32)
    total = torch.zeros(4, dtype=torch.int64, device=dev)
    for w0 in range(0, n_words, BIG_CHUNK):
        m = min(BIG_CHUNK, n_words - w0)
        u = torch.randint(0, 65536, (m, 16), generator=gen, device=dev,
                          dtype=torch.int32)
        codes = sum((u >= c).to(torch.int64) for c in cuts)
        word = (codes << shift).sum(dim=1)
        word = torch.where(word >= 2**31, word - 2**32, word)
        counts = torch.stack([(codes == c).sum(dim=1) for c in range(4)],
                             dim=1)
        occ = torch.cumsum(counts, 0) - counts + total
        total += counts.sum(dim=0)
        rows = torch.stack([occ.to(torch.int32),
                            word.to(torch.int32)[:, None].expand(m, 4)],
                           dim=2)
        o2[4 * w0: 4 * (w0 + m)] = rows.reshape(4 * m, 2).cpu().numpy()
    tot = total.cpu().numpy()
    l2 = np.concatenate([[0], np.cumsum(tot)]).astype(np.int64)
    return {"_o2": o2, "L2": l2, "sa": np.zeros(1, np.int64),
            "pac": np.zeros(1, np.uint8), "primary": seq_len // 3 + 5,
            "seq_len": seq_len, "sa_intv": 32, "l_pac": seq_len // 2,
            "idt": np.int64}


def phase2h(dev, seed: int, smi: str) -> None:
    """Positions past 2**31 on the card: big_table's rank table of
    BIG_SEQ_LEN positions through DeviceFMIndex.from_numpy (int64), and the
    int64 instances of kernels 4 (forward_p3), 5 (forward_pass, chained and
    from starts with min_intv > 1) and 7 (v8, on pass 1's lanes as the
    seeder builds them, min_len 0 and 19) held exactly to their plain
    versions on BIG_READS A-rich reads; how many of the intervals lie above
    2**31. The plain v8 runs without compactions here (MIN_CAP above the
    entries: the compactions rest on v8's facts about a BWT's intervals),
    which changes no output where those hold. Kernel 6 is left out: on a
    table that is not a BWT an SA walk need not end."""
    from mpibwa_tpu_torch.core.opts import mem_opt_init
    from mpibwa_tpu_torch.ops import backward8 as B8
    from mpibwa_tpu_torch.ops import fwd_cuda, seeding
    from mpibwa_tpu_torch.ops import seeding_flat as SF
    from mpibwa_tpu_torch.ops import v8_cuda as V
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.pipeline import device_seed as DS

    t0 = time.time()
    fm = DeviceFMIndex.from_numpy(big_table(dev, seed, BIG_SEQ_LEN), dev)
    torch.cuda.synchronize()
    rows = fm.o2_tables().shape[0]
    HI = 2**31
    log(f"phase 2h a rank table of {BIG_SEQ_LEN} positions (2**31 + 2**24) "
        f"on {smi}: {rows} O2 rows, {rows * 8 / 2**30:.3f} GiB on the card, "
        f"built in {time.time() - t0:.1f} s; base shares {BIG_BASES}, L2 "
        f"{fm.l2_host}, primary {fm.primary}. It is a rank table, not a "
        f"BWT: this phase tests the int64 kernels' 64-bit arithmetic only; "
        f"kernel 6 (the SA walk) is left out, since on a table that is not "
        f"a BWT a walk need not end")
    opt = mem_opt_init()
    msl, mi = opt.min_seed_len, opt.max_mem_intv
    rng = np.random.default_rng(seed)
    B, RL = BIG_READS, 101
    q = torch.from_numpy(rng.choice(4, size=(B, RL), p=READ_BASES)
                         .astype(np.uint8)).to(dev)
    lens = torch.full((B,), RL, dtype=torch.int32, device=dev)
    ones = torch.ones(B, dtype=torch.int64, device=dev)
    wrappers = Spy.kernel_wrappers()
    n0 = {k: fn.launches for k, fn in wrappers.items()}
    errs = {}

    def above(fwd) -> str:
        n = fwd.n_pushed.clamp(max=seeding.F_CAP)
        ok = (torch.arange(seeding.F_CAP, device=dev)[None, :] < n[:, None])
        iv = fwd.ivals[ok]
        return (f"{int(((iv[:, 0] >= HI) | (iv[:, 1] >= HI)).sum())} of "
                f"{len(iv)} pushed intervals with x[0] or x[1] at or above "
                f"2**31")

    got = fwd_cuda.forward_p3_kernel(fm, q, lens, ones, msl, mi)
    want = seeding.forward_p3(fm, q, lens, ones, msl, mi)
    errs["forward_p3"] = fields_err(got, want)
    log(f"phase 2h forward_p3 (B={B}, L={RL}, int64): max_abs_err="
        f"{errs['forward_p3']} over every field of both automata; "
        f"{above(want[0])}; pass-3 seeds {int(want[1].n_seeds.sum())}")
    starts = torch.from_numpy(rng.integers(0, RL, B).astype(np.int32)).to(dev)
    minv = torch.from_numpy(rng.integers(1, 4, B)).to(dev)
    errs["forward_pass"] = 0
    for chain, st, mv in ((True, None, ones), (False, starts, minv)):
        got = fwd_cuda.forward_pass_kernel(fm, q, lens, mv, chain, st)
        fwd = seeding.forward_pass(fm, q, lens, mv, chain, st)
        err = fields_err(got, fwd)
        errs["forward_pass"] = max(errs["forward_pass"], err)
        log(f"phase 2h forward_pass (chain={chain}, B={B}, int64): "
            f"max_abs_err={err} over every field; {above(fwd)}; "
            f"{int(fwd.n_calls.sum())} calls")
        if chain:
            fwd1 = fwd
    # kernel 7 on pass 1's lanes, as the seeder builds them
    nc = fwd1.n_calls.clamp(max=seeding.C_CAP).cpu().numpy()
    ov = fwd1.overflow.cpu().numpy()
    cs, cl, cx = (t.cpu().numpy() for t in (fwd1.call_start, fwd1.call_len,
                                            fwd1.call_x))
    arr = np.array([(b, cs[b, c], cl[b, c], cx[b, c], 1) for b in range(B)
                    if not ov[b] for c in range(nc[b])], np.int64)
    NL = DS._v8_lanes(len(arr))
    lane_row, lane_tbl, x0, mv1, e = DS._lane_tables(arr, NL)
    lrow = torch.from_numpy(lane_row).to(dev)
    entry = SF.assemble_entries(fwd1.ivals, fwd1.infos, lrow,
                                torch.from_numpy(lane_tbl).to(dev),
                                B8.cap_bucket(e, 1024))
    qrows = q[lrow.long()]
    E = entry[0].shape[0]
    live_hi = int((entry[3] & (entry[0][:, 0] >= HI)).sum())
    errs["bwd_v8"] = 0
    real_cap = B8.MIN_CAP
    B8.MIN_CAP = E + 1
    try:
        for min_len in (0, 19):
            got, gov = V.v8_pass_kernel(fm, qrows, entry, NL, x0, mv1,
                                        min_len=min_len, raw=True,
                                        est_rows=E,
                                        max_len=int(arr[:, 2].max()))
            want, wov = B8.run_backward8(fm, qrows, entry, NL, x0, mv1,
                                         min_len=min_len, raw=True,
                                         est_rows=E)
            err = rows_err(got, V.lane_order(want))
            if gov or wov:
                err = max(err, 1)
            errs["bwd_v8"] = max(errs["bwd_v8"], err)
            log(f"phase 2h bwd_v8 (E={E}, {int(entry[3].sum())} live entries "
                f"in {len(arr)} lanes, int64, min_len {min_len}): "
                f"max_abs_err={err} over the {len(got)} rows against the "
                f"plain v8 in lane order; {live_hi} live entries with x[0] "
                f"at or above 2**31, {int((got[:, 0] >= HI).sum())} rows")
    finally:
        B8.MIN_CAP = real_cap
    n = {k: fn.launches - n0[k] for k, fn in wrappers.items()}
    log(f"phase 2h kernel launches {n}; max_abs_err {errs}")
    del fm, entry, qrows
    torch.cuda.empty_cache()
    if any(errs.values()) or min(n[k] for k in errs) <= 0:
        raise Failed(f"phase 2h: an int64 kernel disagrees past 2**31 or "
                     f"did not launch: {errs}, {n}")


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
    (rows, _, _), ms_rows = timed(lambda: BC.pull_rows(
        BC.pack_emitted(st, ent[1], lanes.lane_e, msl), N // 8 + 1024))

    def lists_route():
        every = BC.pull_rows(BC.pack_emitted(st, ent[1], lanes.lane_e),
                             st.shape[1])[0]
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


# -- phase 2g: the device loops' kernels against their plain versions --------

def fields_err(got, want) -> int:
    """Max abs difference over every field of two output tuples (nested
    tuples of tensors, bools as 0/1); shapes and dtypes must agree."""
    if isinstance(want, torch.Tensor):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise Failed(f"output {tuple(got.shape)} {got.dtype} against "
                         f"{tuple(want.shape)} {want.dtype}")
        return max_err(got, want)
    return max(fields_err(g, w) for g, w in zip(got, want))


def fwd_bound(st: dict, q, lens, fwd, p3=None, starts: bool = False
              ) -> "tuple[float, str, int, int]":
    """Bound of one launch of a forward kernel: each O2 sector the lanes'
    needed extensions read once (st, from the plain run), the bytes of the
    reads the lanes look at (to lens + 1), lens, min_intv (and starts),
    and the entries the kernel writes; operations OPS_PER_O2_STEP an
    extension. Returns (ms, by, bytes, operations)."""
    from mpibwa_tpu_torch.ops.seeding import C_CAP, F_CAP, S3_CAP

    B, L = q.shape
    pos = fwd.ivals.element_size()
    nbytes = SECTOR * st["sectors"]
    nbytes += int((lens.long() + 1).clamp(max=L).sum())
    nbytes += B * (4 + pos + (4 if starts else 0))
    nbytes += int(fwd.n_pushed.clamp(max=F_CAP).sum()) * (3 * pos + 4)
    nbytes += int(fwd.n_calls.clamp(max=C_CAP).sum()) * 12 + B * 9
    if p3 is not None:
        nbytes += (int(p3.n_seeds.clamp(max=S3_CAP).sum()) * (3 * pos + 8)
                   + B * 5)
    ops = OPS_PER_O2_STEP * st["steps"]
    return bound(nbytes, ops) + (nbytes, ops)


def launch_ms(go, reps: int) -> float:
    """A kernel's own time: `reps` launches back to back (go, into the same
    outputs) between two CUDA events, over reps; the median of 3 such runs
    after a warm-up. The wrapper's output allocation and zero-fill, and its
    host work, are left out."""
    go()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            go()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


FLUSH_BYTES = 128 << 20  # written before each cold launch: over twice the L2


def cold_ms(go, reps: int = 11) -> float:
    """A kernel's own time with its inputs out of the L2 cache, as a
    main-path call finds them (back-to-back launches of a small walk find
    its sectors in the L2): each launch alone between two CUDA events,
    after FLUSH_BYTES written outside them; the median of reps after a
    warm-up. One launch's start-up is included."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                      device=go.keep[0].device)
    go()
    times = []
    for i in range(reps):
        buf.fill_(i)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        go()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def loop_launcher(name, idx, *a, lib=None):
    """A launch of loop kernel `name` through the C entry point its wrapper
    calls (or the same symbol of the ctypes library `lib`: --fwd-turns),
    on the wrapper's arguments, into zero-filled outputs allocated once
    here (``go.out``; a kernel's outputs do not depend on what they held
    before). Not counted: the wrapper is not called."""
    from mpibwa_tpu_torch.ops import _build, fwd_cuda, sa_cuda
    from mpibwa_tpu_torch.ops.seeding import C_CAP, F_CAP, S3_CAP, Pass3Out

    dev = idx.o2_tables().device
    if name == "sa_walk":
        (ks,) = a
        out = torch.zeros_like(ks)
        args = (idx.sa.data_ptr(), idx.sa.shape[0],
                idx.sa_intv.bit_length() - 1, ks.data_ptr(), len(ks),
                out.data_ptr())
        entry = sa_cuda.ENTRY
        keep = (ks,)
    else:
        q, lens, minv = fwd_cuda._inputs(idx, *a[:3])
        B, L = q.shape
        fwd = fwd_cuda._fwd_out(idx, B, q.device)
        keep = (q, lens, minv, fwd)
        if name == "forward_p3":
            p3 = Pass3Out(torch.zeros((B, S3_CAP, 3), dtype=idx.idt,
                                      device=dev),
                          torch.zeros((B, S3_CAP), dtype=torch.int64,
                                      device=dev),
                          torch.zeros(B, dtype=torch.int32, device=dev),
                          torch.zeros(B, dtype=torch.bool, device=dev))
            out = (fwd, p3)
            args = (q.data_ptr(), B, L, lens.data_ptr(), minv.data_ptr(),
                    F_CAP, C_CAP, S3_CAP, *(int(v) for v in a[3:]),
                    *(t.data_ptr() for t in fwd), *(t.data_ptr() for t in p3))
            entry = fwd_cuda.ENTRY_P3
        else:
            chain, starts = a[3:]
            if starts is not None:
                starts = starts.to(torch.int32).contiguous()
                keep += (starts,)
            args = (q.data_ptr(), B, L, lens.data_ptr(), minv.data_ptr(),
                    None if starts is None else starts.data_ptr(),
                    int(chain), F_CAP, C_CAP, *(t.data_ptr() for t in fwd))
            entry = fwd_cuda.ENTRY_PASS
            out = fwd
    if lib is None:
        fn = _build.entry(*entry)
    else:
        fn = getattr(lib, entry[1])
        fn.argtypes, fn.restype = entry[2], ctypes.c_int

    def go():
        if _build.launch_on(dev, fn, *idx.o2_args(), *args) != 0:
            raise Failed(f"a timing launch of {name} failed")
    go.keep, go.out = keep, out  # the tensors behind the pointers
    return go


def wide_lane(lens) -> int:
    """The lane of phase 14c's wide read in its captured batch: the longest
    row. It is the batch's last read only when the batch fills a
    microbatch; a shorter tail is padded with dummy reads after it
    (DeviceAligner._microbatches)."""
    return int(torch.argmax(lens.cpu()))


def splice_lane(part, lane: dict, k: int):
    """part (a FwdOut or Pass3Out of the plain loop over every lane of a
    batch but k) with one lane's outputs (numpy arrays by field name, as
    plain_wide saves them without their prefix) put back at lane k, on the
    CPU."""
    return type(part)(*(torch.cat([a[:k].cpu(), torch.from_numpy(lane[n]),
                                   a[k:].cpu()])
                        for n, a in zip(part._fields, part)))


def wide_case(fm, call, side, wide_out, one, worst, msl, mi,
              floor) -> None:
    """forward_p3 on phase 14c's batch against the plain loop: over the
    other lanes on the card here, and over the wide read (wide_lane) as
    the side process wrote it (plain_wide, on the CPU)."""
    from mpibwa_tpu_torch.ops import fwd_cuda, seeding

    q, lens, _ = call
    ones = torch.ones(len(q), dtype=torch.int64, device=q.device)
    k = wide_lane(lens)
    if int(lens[k]) != WIDE_BP:
        raise Failed(f"phase 2g: the longest read of phase 14c's batch has "
                     f"{int(lens[k])} bases, not {WIDE_BP}")
    got = one("forward_p3", fwd_cuda.forward_p3_kernel, fm, q, lens, ones,
              msl, mi)
    ms = launch_ms(loop_launcher("forward_p3", fm, q, lens, ones, msl, mi), 3)
    others = torch.cat([torch.arange(k), torch.arange(k + 1, len(q))]).to(
        q.device)
    t = time.perf_counter()
    short = seeding.forward_p3(fm, q[others], lens[others], ones[others],
                               msl, mi)
    torch.cuda.synchronize()
    short_s = time.perf_counter() - t
    t = time.perf_counter()
    try:
        rc = side.wait(timeout=SIDE_WAIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    waited = time.perf_counter() - t
    if rc != 0:
        with open(wide_out + ".log") as fh:
            raise Failed(f"phase 2g: the plain run of phase 14c's wide read "
                         f"{'timed out' if rc is None else f'exited {rc}'}"
                         f":\n{fh.read()[-3000:]}")
    d = np.load(wide_out)
    want = tuple(splice_lane(part, {n: d[f"{pre}_{n}"] for n in part._fields},
                             k)
                 for part, pre in zip(short, ("fwd", "p3")))
    err = fields_err(tuple(type(g)(*(t.cpu() for t in g)) for g in got),
                     want)
    worst["forward_p3"] = max(worst["forward_p3"], err)
    steps = int(d["steps"])
    log(f"phase 2g forward_p3 phase 14c's batch with the wide read "
        f"(B={q.shape[0]}, L={q.shape[1]}, {fm.idt}, the wide read at lane "
        f"{k}): max_abs_err={err} over every field of both automata against "
        f"the plain loop, over the other lanes on the card ({short_s:.2f} s) "
        f"and over the wide read alone on the CPU in a side process "
        f"({float(d['seconds']):.1f} s, "
        f"{steps} rounds with up to 3 over-steps; waited {waited:.1f} s for "
        f"it here); fallback lanes {int(want[0].overflow.sum())}, pass-3 "
        f"overflow {int(want[1].overflow.sum())}; kernel {ms:.4f} ms (3 "
        f"launches back to back, median of 3, CUDA events), "
        f"{ms * 1e3 / max(steps, 1):.3f} us a step; "
        f"{floor(ms, steps)}")


PROBE = (("one thread", 1, 1, 4000), ("a warp on every SM", None, 32, 2000),
         ("1,024 threads on every SM", None, 1024, 500))


L2_FETCH_BYTES = 32  # phase 2g's probe again at this L2 fetch granularity


def l2_fetch_granularity(nbytes: int) -> int:
    """Set the device's L2 fetch granularity limit to nbytes (0: leave it)
    through csrc/sa_walk.cu; returns the value it held before."""
    from mpibwa_tpu_torch.ops import _build

    fn = _build.entry("sa_walk", "mpibwa_l2_fetch_granularity",
                      [ctypes.c_longlong,
                       ctypes.POINTER(ctypes.c_longlong)])
    before = ctypes.c_longlong(-1)
    rc = fn(nbytes, ctypes.byref(before))
    if rc != 0:
        raise Failed(f"phase 2g: cudaLimitMaxL2FetchGranularity "
                     f"{nbytes}: cudaError {rc}")
    return before.value


def latency_probe(fm) -> "tuple[float, float]":
    """The dependent-load probe of csrc/sa_walk.cu on the index's O2
    table: one thread, one warp on each SM, then every SM full, each
    thread chasing random sectors, every load's address a hash of the row
    before (CUDA events, median of 5); then all three again with the L2
    fetch granularity set to L2_FETCH_BYTES, and the card's own value put
    back. Returns one thread's us a dependent load (the latency floor's
    unit) and the full card's random loads a second, both at the card's
    default."""
    default = l2_fetch_granularity(0)
    got = probe_once(fm, f"L2 fetch granularity {default} B (the card's "
                     f"default)")
    l2_fetch_granularity(L2_FETCH_BYTES)
    try:
        small = probe_once(fm, f"L2 fetch granularity {L2_FETCH_BYTES} B")
    finally:
        l2_fetch_granularity(default)
    if l2_fetch_granularity(0) != default:
        raise Failed("phase 2g: the L2 fetch granularity was not restored")
    log(f"phase 2g latency probe, L2 fetch granularity {L2_FETCH_BYTES} B "
        f"against {default} B: one thread {small[0]:.4f} against "
        f"{got[0]:.4f} us a load, every SM full {small[1] / 1e9:.3f} "
        f"against {got[1] / 1e9:.3f} G loads a second ({small[1] / got[1]:.3f}"
        f"x; restored to {default} B; every other phase runs at the "
        f"default)")
    return got


def probe_once(fm, setting: str) -> "tuple[float, float]":
    """latency_probe's three launches at the current L2 setting: (one
    thread's us a load, the full card's loads a second)."""
    from mpibwa_tpu_torch.ops import _build

    fn = _build.entry("sa_walk", "mpibwa_latency_probe",
                      [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_void_p, ctypes.c_void_p])
    o2 = fm.o2_tables()
    sms = torch.cuda.get_device_properties(o2.device).multi_processor_count
    us = {}
    for tag, blocks, threads, steps in PROBE:
        blocks = blocks or sms
        out = torch.empty(blocks * threads, dtype=torch.int32,
                          device=o2.device)
        seeds = iter(range(1, 1000))

        def go():  # a new seed each launch: no sector left in the L2
            rc = _build.launch_on(o2.device, fn, o2.data_ptr(), o2.shape[0],
                                  blocks, threads, steps, next(seeds) * 7919,
                                  out.data_ptr())
            if rc != 0:
                raise Failed(f"phase 2g: the latency probe's launch failed "
                             f"(cudaError {rc})")

        ms = median_ms(go, 5)
        us[tag] = ms * 1e3 / steps
        rate = blocks * threads * steps / ms * 1e3
        log(f"phase 2g latency probe, {setting}, {tag} ({blocks} x "
            f"{threads} threads, {steps} dependent 8-byte loads each over "
            f"the {o2.shape[0]}-row O2 table, {o2.numel() * 4 / 1e9:.3f} "
            f"GB): {us[tag]:.4f} us a load, {rate / 1e9:.3f} G loads a "
            f"second (median of 5, CUDA events)")
    return us["one thread"], rate


def ptxas_lines(name: str) -> "list[str]":
    """Registers and spills of each kernel of csrc/<name>.cu, from nvcc's
    -Xptxas -v report of this run's build."""
    from mpibwa_tpu_torch.ops import _build

    out = []
    for fn, body in re.findall(r"Compiling entry function '(\S+)' for "
                               r"'sm_90a'(.*?)(?=Compiling entry|\Z)",
                               _build.build_logs.get(name, ""), re.S):
        kernel = re.search(r"(forward_p3|forward_pass|sa_walk|latency_probe"
                           r"|bwd_v8)_kernel", fn)
        # a template's last argument is the position type (x: long long,
        # i: int); kernel 7's first, Li<S>E, its slot count
        slots = re.search(r"ILi(\d+)E[ix]E", fn)
        ptype = ("int64" if re.search(r"[IE]xE", fn) else "int32"
                 if re.search(r"[IE]iE", fn) else "")
        if slots:
            ptype += f" {slots.group(1)} slots"
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", body)
        line = (f"{kernel.group(0) if kernel else fn} {ptype}: "
                f"{regs.group(1) if regs else '?'} registers, "
                f"{spill.group(1) if spill else '?'} B spill stores, "
                f"{spill.group(2) if spill else '?'} B spill loads")
        if kernel and kernel.group(1) == "bwd_v8" and regs:
            line += (f", {warps_per_sm(int(regs.group(1)))} resident warps "
                     f"an SM by registers (blocks of 128 threads)")
        out.append(line)
    return out


def phase2g(fm, fm64, spy, launches, side, wide_out, v8_calls) -> dict:
    """The forward automata and SA walk kernels against their plain versions
    (ops/seeding.forward_p3, forward_pass, ops/fmd._sa_lookup16) on the
    card, every output field equal: forward_p3 on phase 4's first
    microbatch, phase 14a's long reads and phase 14c's batch with the wide
    read (the wide lane's plain run from the side process that
    start_plain_wide started); forward_pass on pass 2's first lanes
    (starts, min_intv > 1) and chained on phase 4's first microbatch and
    14a's reads; the SA walk on phase 4's first prefetch plus 0, primary,
    seq_len and multiples of sa_intv; phase 4's inputs again on the int64
    index; kernel 7 (v8) on the first pass-1 backward of phase 11 (int32)
    and of phase 2i (int64) against the plain torch v8 (v8_calls). Kernel
    and plain times (CUDA events, medians) at the main path's shapes, each
    launch's bound and its latency floor: the longest lane's steps (rounds)
    times one dependent O2 load, as the probe measured it (latency_probe);
    the kernels' registers and spills."""
    from mpibwa_tpu_torch.core.opts import mem_opt_init
    from mpibwa_tpu_torch.ops import fwd_cuda, sa_cuda, seeding
    from mpibwa_tpu_torch.ops.fmd import _sa_lookup16

    if ("4" not in spy.fwd_calls or "14a" not in spy.fwd_calls
            or "14c" not in spy.fwd_calls or spy.p2_call is None
            or spy.sa_ks is None):
        raise Failed("phase 2g: the main path's forward or SA inputs were "
                     "not captured")
    opt = mem_opt_init()
    msl, mi = opt.min_seed_len, opt.max_mem_intv
    wrappers = Spy.kernel_wrappers()
    worst = {k: 0 for k in LOOP_KERNELS + ("bwd_v8",)}
    res = {}
    for name in ("fwd_automata", "sa_walk", "bwd_v8"):
        for line in ptxas_lines(name):
            log(f"phase 2g -Xptxas -v {name}.cu {line}")
    lat_us, rate = latency_probe(fm)

    def floor(ms, rounds, loads=None) -> str:
        f_ms = rounds * lat_us / 1e3
        line = (f"latency floor {rounds} dependent loads x {lat_us:.4f} us "
                f"= {f_ms:.5f} ms, {f_ms / ms:.4f} of the kernel's time")
        if loads is not None:  # the steps' sector loads at the probe's rate
            r_ms = loads / rate * 1e3
            line += (f"; random-load floor {loads} sector loads at "
                     f"{rate / 1e9:.3f} G a second = {r_ms:.5f} ms, "
                     f"{r_ms / ms:.4f} of the kernel's time")
        return line

    def one(name, f, *a):
        n0 = wrappers[name].launches
        out = f(*a)
        torch.cuda.synchronize()
        if wrappers[name].launches != n0 + 1:
            raise Failed(f"phase 2g: {name} took other than one launch")
        return out

    def p3_case(tag, idx, q, lens, timed):
        ones = torch.ones(len(q), dtype=torch.int64, device=q.device)
        got = one("forward_p3", fwd_cuda.forward_p3_kernel, idx, q, lens,
                  ones, msl, mi)
        st = {}
        t = time.perf_counter()
        want = seeding.forward_p3(idx, q, lens, ones, msl, mi, stats=st)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        err = fields_err(got, want)
        worst["forward_p3"] = max(worst["forward_p3"], err)
        line = (f"phase 2g forward_p3 {tag} (B={q.shape[0]}, L={q.shape[1]}, "
                f"{idx.idt}): max_abs_err={err} over every field of both "
                f"automata; {st['rounds']} rounds (the longest lane's steps), "
                f"{st['steps']} extensions, {st['sectors']} distinct O2 "
                f"sectors; fallback lanes {int(want[0].overflow.sum())}, "
                f"pass-3 overflow {int(want[1].overflow.sum())}; plain once "
                f"{plain_s * 1e3:.1f} ms (counting on)")
        ms = launch_ms(loop_launcher("forward_p3", idx, q, lens, ones, msl,
                                     mi), 20 if timed else 3)
        if timed:
            call_ms = median_ms(lambda: fwd_cuda.forward_p3_kernel(
                idx, q, lens, ones, msl, mi), 5)
            plain_ms = median_ms(lambda: seeding.forward_p3(
                idx, q, lens, ones, msl, mi), 3)
            b_ms, b_by, nb, ops = fwd_bound(st, q, lens, got[0], got[1])
            line += (f"; kernel {ms:.4f} ms (20 launches back to back, "
                     f"median of 3), the wrapper's call with its zero-filled "
                     f"outputs {call_ms:.4f} ms (median of 5), plain "
                     f"{plain_ms:.1f} ms (median of 3), CUDA events; bound "
                     f"{b_ms:.5f} ms by {b_by} ({nb} B, {ops} operations), "
                     f"{b_ms / ms:.4f} of the kernel's time; "
                     f"{floor(ms, st['rounds'], st['loads'])}; "
                     f"{ms * 1e3 / max(st['rounds'], 1):.3f} us a step")
            if idx is fm:
                res["forward_p3"] = {"ms": ms, "call_ms": call_ms,
                                     "plain_ms": plain_ms, "bound_ms": b_ms,
                                     "bound_by": b_by, "steps": st["rounds"]}
        else:
            line += (f"; kernel {ms:.4f} ms (3 launches back to back, median "
                     f"of 3, CUDA events), "
                     f"{ms * 1e3 / max(st['rounds'], 1):.3f} us a step; "
                     f"{floor(ms, st['rounds'])}")
        log(line)

    def pass_case(tag, idx, q, lens, minv, chain, starts, timed):
        got = one("forward_pass", fwd_cuda.forward_pass_kernel, idx, q, lens,
                  minv, chain, starts)
        st = {}
        want = seeding.forward_pass(idx, q, lens, minv, chain, starts,
                                    stats=st)
        err = fields_err(got, want)
        worst["forward_pass"] = max(worst["forward_pass"], err)
        ms = launch_ms(loop_launcher("forward_pass", idx, q, lens, minv, chain,
                                     starts), 20)
        call_ms = median_ms(lambda: fwd_cuda.forward_pass_kernel(
            idx, q, lens, minv, chain, starts), 5)
        line = (f"phase 2g forward_pass {tag} (chain={chain}, B={q.shape[0]}, "
                f"L={q.shape[1]}, {idx.idt}): max_abs_err={err} over every "
                f"field; {st['rounds']} rounds, {st['steps']} extensions, "
                f"{st['sectors']} distinct O2 sectors, "
                f"{int(want.n_calls.sum())} calls; kernel {ms:.4f} ms (20 "
                f"launches back to back, median of 3), the wrapper's call "
                f"with its zero-filled outputs {call_ms:.4f} ms (median of "
                f"5), CUDA events")
        if timed:
            plain_ms = median_ms(lambda: seeding.forward_pass(
                idx, q, lens, minv, chain, starts), 3)
            b_ms, b_by, nb, ops = fwd_bound(st, q, lens, got,
                                            starts=starts is not None)
            line += (f", plain {plain_ms:.2f} ms (median of 3); bound "
                     f"{b_ms:.5f} ms by {b_by} ({nb} B, {ops} operations), "
                     f"{b_ms / ms:.4f} of the kernel's time; "
                     f"{floor(ms, st['rounds'], st['loads'])}; "
                     f"{ms * 1e3 / max(st['rounds'], 1):.3f} us a step")
            if idx is fm:
                res["forward_pass"] = {"ms": ms, "call_ms": call_ms,
                                       "plain_ms": plain_ms,
                                       "bound_ms": b_ms, "bound_by": b_by,
                                       "steps": st["rounds"]}
        log(line)

    def sa_case(tag, idx, ks, timed):
        got = one("sa_walk", sa_cuda.sa_walk_kernel, idx, ks)
        st = {}
        args = (idx.o2_tables(), idx.L2, idx.primary, idx.seq_len, idx.sa,
                idx.sa_intv)
        want = _sa_lookup16(*args, ks, stats=st)
        err = fields_err(got, want)
        worst["sa_walk"] = max(worst["sa_walk"], err)
        go = loop_launcher("sa_walk", idx, ks)
        ms, cold = launch_ms(go, 20), cold_ms(go)
        call_ms = median_ms(lambda: sa_cuda.sa_walk_kernel(idx, ks), 5)
        plain_ms = median_ms(lambda: _sa_lookup16(*args, ks), 3)
        isz = ks.element_size()
        nb = (SECTOR * (st["sectors"] + st["sa_rows"]) + 2 * isz * len(ks))
        ops = OPS_PER_SA_STEP * st["steps"]
        b_ms, b_by = bound(nb, ops)
        log(f"phase 2g sa_walk {tag} (N={len(ks)}, {idx.idt}): "
            f"max_abs_err={err}; {st['rounds']} rounds (the longest walk), "
            f"{st['steps']} steps, {st['sectors']} distinct O2 sectors, "
            f"{st['sa_rows']} SA rows; kernel {ms:.4f} ms (20 launches back "
            f"to back, median of 3), {cold:.4f} ms with the L2 flushed (one "
            f"launch, median of 11), the wrapper's call {call_ms:.4f} ms "
            f"(median of 5), plain {plain_ms:.2f} ms (median of 3), CUDA "
            f"events; bound "
            f"{b_ms:.5f} ms by {b_by} ({nb} B, {ops} operations), "
            f"{b_ms / ms:.4f} of the kernel's time; "
            f"{floor(ms, st['rounds'], st['steps'])}; "
            f"{ms * 1e3 / max(st['rounds'], 1):.3f} us a step")
        if timed and idx is fm:
            res["sa_walk"] = {"ms": ms, "cold_ms": cold, "call_ms": call_ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "steps": st["rounds"]}
        sets = {"a": (ms, cold)}
        for name, what, sub in sa_sets(ks, st["walk_steps"])[1:]:
            got = one("sa_walk", sa_cuda.sa_walk_kernel, idx, sub)
            sst = {}
            err = fields_err(got, _sa_lookup16(*args, sub, stats=sst))
            worst["sa_walk"] = max(worst["sa_walk"], err)
            go = loop_launcher("sa_walk", idx, sub)
            sets[name] = w_ms, c_ms = launch_ms(go, 20), cold_ms(go)
            rounds = max(sst["rounds"], 1)
            log(f"phase 2g sa_walk set ({name}) {what} (N={len(sub)}, "
                f"{idx.idt}): max_abs_err={err}; {sst['rounds']} rounds, "
                f"{sst['steps']} steps; kernel {w_ms:.4f} ms (20 launches "
                f"back to back, median of 3), {w_ms * 1e3 / rounds:.4f} us "
                f"a round; with the L2 flushed {c_ms:.4f} ms (one launch, "
                f"median of 11), {c_ms * 1e3 / rounds:.4f} us a round; CUDA "
                f"events; {floor(c_ms, sst['rounds'], sst['steps'])} (with "
                f"the L2 flushed)")
        log(f"phase 2g sa_walk sets ({idx.idt}), ms back to back / with the "
            f"L2 flushed: " + ", ".join(
                f"({k}) {w:.4f} / {c:.4f}" for k, (w, c) in sets.items())
            + f"; (b) + (c) {sets['b'][0] + sets['c'][0]:.4f} / "
            f"{sets['b'][1] + sets['c'][1]:.4f} against (a); the lone "
            f"dependent load {lat_us:.4f} us")

    q4, l4, _ = spy.fwd_calls["4"]
    q2, l2, m2, s2 = spy.p2_call
    ks = sa_edge_ks(fm, spy.sa_ks)
    ones4 = torch.ones(len(q4), dtype=torch.int64, device=q4.device)
    for idx in (fm, fm64):
        p3_case("phase 4's first microbatch", idx, q4, l4, True)
        pass_case("pass 2's first lanes of phase 4", idx, q2, l2, m2, False,
                  s2, True)
        pass_case("phase 4's first microbatch", idx, q4, l4, ones4, True,
                  None, False)
        sa_case("phase 4's first SA prefetch + edge indices", idx,
                ks.to(idx.idt), True)
    qa, la, _ = spy.fwd_calls["14a"]
    p3_case("phase 14a's long reads", fm, qa, la, False)
    pass_case("phase 14a's long reads", fm, qa, la,
              torch.ones(len(qa), dtype=torch.int64, device=qa.device), True,
              None, False)
    wide_case(fm, spy.fwd_calls.pop("14c"), side, wide_out, one, worst, msl,
              mi, floor)
    v8 = {}
    for key, call in v8_calls.items():
        what = {"int32": "phase 11's first pass-1 backward",
                "int64": "phase 2i's first pass-1 backward",
                "int32 pass 2": "phase 11's first pass-2 backward"}[key]
        v8[key] = v8_case(what, call, floor, key[:5], rate)
        worst["bwd_v8"] = max(worst["bwd_v8"], v8[key].pop("max_abs_err"))
    # the int64 index is kernel 7's main path (MPIBWA_BWD=auto)
    res["bwd_v8"] = dict(v8["int64"], steps=v8["int64"].pop("rounds"),
                         int32=v8["int32"], int32_pass2=v8["int32 pass 2"])
    for name in LOOP_KERNELS + ("bwd_v8",):
        r = res[name]
        r["latency_floor_ms"] = r.pop("steps") * lat_us / 1e3
        run = "phase 11's" if name == "bwd_v8" else "phase 4's"
        log(f"phase 2g {name}: {launches[name]} launches in {run} PE "
            f"run; kernel {r['ms']:.4f} ms (the wrapper's call "
            f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.2f} ms, "
            f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bound_ms'] / r['ms']:.4f} of the kernel's time), latency "
            f"floor {r['latency_floor_ms']:.5f} ms "
            f"({r['latency_floor_ms'] / r['ms']:.4f} of the kernel's time), "
            f"max_abs_err {worst[name]}")
        r["max_abs_err"] = worst[name]
    if any(worst.values()):
        raise Failed(f"phase 2g: a loop kernel disagrees with its plain "
                     f"version: {worst}")
    return res


def sa_edge_ks(fm, sa_ks) -> torch.Tensor:
    """Phase 4's first SA prefetch plus 0, primary, seq_len and multiples
    of sa_intv, int64."""
    edges = [0, fm.primary, fm.seq_len] + list(
        range(0, fm.seq_len + 1, fm.sa_intv * 997))[:1000]
    return torch.cat([sa_ks.to(torch.int64),
                      torch.tensor(edges, dtype=torch.int64,
                                   device=sa_ks.device)])


def sa_sets(ks, walk_steps) -> list:
    """The SA walk's sets of phase 2g, [(name, what, indices)]: (a) all of
    ks; (b) all but the 1% longest walks (the heavy phase, every walk in
    flight); (c) the 1% longest walks alone (the latency tail: time over
    rounds is a step at low load); (d) the longest walk alone (a step with
    nothing else in flight). Each keeps ks's order."""
    n_tail = -(-len(ks) // 100)
    tail = torch.zeros(len(ks), dtype=torch.bool, device=ks.device)
    tail[torch.argsort(walk_steps, stable=True)[-n_tail:]] = True
    longest = int(torch.argmax(walk_steps))
    return [("a", "all", ks),
            ("b", "all but the 1% longest walks", ks[~tail]),
            ("c", "the 1% longest walks alone", ks[tail]),
            ("d", "the longest walk alone", ks[longest: longest + 1])]


# -- --fwd-turns: kernels 4 and 5 against other builds, in turns --------------

TURN_PAIRS = 8_192  # one microbatch of 16,384 reads


def build_turn_libs(dirs, name: str = "fwd_automata") -> dict:
    """This checkout's csrc/<name>.cu and each DIR's (with the o2.cuh
    beside it), built side by side with nvcc into
    build/kernels/turns/<name>/; {label: ctypes library}, this checkout
    first as "this"."""
    from mpibwa_tpu_torch.ops import _build

    libs = {"this": _build.load(name)}
    for line in ptxas_lines(name):
        log(f"turns this: -Xptxas -v {line}")
    jobs = []
    for i, d in enumerate(dirs):
        out = os.path.join(REPO, "build", "kernels", "turns", name, str(i))
        os.makedirs(out, exist_ok=True)
        so = os.path.join(out, f"lib{name}.so")
        cmd = ([_build._nvcc()] + _build.ARCH_FLAGS
               + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                  "-Xptxas", "-v", "-o", so, os.path.join(d, name + ".cu")])
        jobs.append((d, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE,
                                             text=True)))
    for d, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise Failed(f"turns: nvcc failed for {d}:\n{err}")
        _build.build_logs[d] = err
        for line in ptxas_lines(d):
            log(f"turns {d}: -Xptxas -v {line}")
        libs[d] = ctypes.CDLL(so)
    return libs


def time_turns(tag, libs, name, idx, args, reps, steps, want,
               unit="step", cold=False) -> None:
    """Each build once against want (every field), then all timed in turns,
    A B .. B A (launch_ms: the kernel alone, reps launches back to back;
    with cold, also cold_ms: one launch with the L2 flushed)."""
    gos = {k: loop_launcher(name, idx, *args, lib=lib)
           for k, lib in libs.items()}
    for k, go in gos.items():
        go()
        torch.cuda.synchronize()
        err = fields_err(go.out, want)
        if err:
            raise Failed(f"turns {tag}: {k} differs ({err})")
    order = list(libs)
    ms = {k: [] for k in order}
    flushed = {k: [] for k in order}
    for k in order + order[::-1]:
        ms[k].append(launch_ms(gos[k], reps))
        if cold:
            flushed[k].append(cold_ms(gos[k]))
    log(f"turns {tag}: every build max_abs_err=0; in turns (kernel "
        f"alone, {reps} launches back to back, median of 3, CUDA events): "
        + "; ".join(f"{k} {' / '.join(f'{t:.4f}' for t in ms[k])} ms "
                    f"({np.median(ms[k]) * 1e3 / steps:.3f} us a {unit})"
                    for k in order))
    if cold:
        log(f"turns {tag}: with the L2 flushed (one launch, median of 11, "
            f"CUDA events): " + "; ".join(
                f"{k} {' / '.join(f'{t:.4f}' for t in flushed[k])} ms "
                f"({np.median(flushed[k]) * 1e3 / steps:.3f} us a {unit})"
                for k in order))


def fwd_turns(args) -> int:
    """--fwd-turns DIR ...: kernels 4 and 5 of this checkout against the
    builds of other fwd_automata.cu sources with the same C entry points
    (an earlier design, another group width), on one card: the inputs of
    the first microbatch of a PE run on TURN_PAIRS pairs (forward_p3, pass
    2's first lanes, the chained forward_pass), at both position types,
    and forward_p3 on a 14c-like batch (its first 16,383 reads and one
    66,000-bp read off the genome) and on that read alone. Every build is
    held to the plain loops (the wide batch: to this checkout's output,
    which phase 2g holds to them) and timed in turns."""
    import _torch_toy
    from mpibwa_tpu_torch.core.opts import mem_opt_init
    from mpibwa_tpu_torch.ops import seeding

    libs = build_turn_libs(args.fwd_turns)
    chrom, fm, fm64, spy = turn_inputs(args)
    opt = mem_opt_init()
    msl, mi = opt.min_seed_len, opt.max_mem_intv
    q4, l4, _ = spy.fwd_calls["4"]
    q2, l2, m2, s2 = spy.p2_call
    ones = torch.ones(len(q4), dtype=torch.int64, device=q4.device)
    for idx in (fm, fm64):
        st = {}
        want = seeding.forward_p3(idx, q4, l4, ones, msl, mi, stats=st)
        time_turns(f"forward_p3 phase 4's first microbatch (B={len(q4)}, "
                   f"{idx.idt}, {st['rounds']} rounds)", libs, "forward_p3",
                   idx, (q4, l4, ones, msl, mi), 20, st["rounds"], want)
        st = {}
        want = seeding.forward_pass(idx, q2, l2, m2, False, s2, stats=st)
        time_turns(f"forward_pass pass 2's first lanes (B={len(q2)}, "
                   f"{idx.idt}, {st['rounds']} rounds)", libs,
                   "forward_pass", idx, (q2, l2, m2, False, s2), 20,
                   st["rounds"], want)
        st = {}
        want = seeding.forward_pass(idx, q4, l4, ones, True, None, stats=st)
        time_turns(f"forward_pass chained on phase 4's first microbatch "
                   f"({idx.idt}, {st['rounds']} rounds)", libs,
                   "forward_pass", idx, (q4, l4, ones, True, None), 20,
                   st["rounds"], want)
    wide = wide_read(_torch_toy.to_codes(chrom), args.seed + 3)
    qw = torch.full((len(q4), WIDE_BP), 4, dtype=torch.uint8,
                    device=q4.device)
    qw[:, : q4.shape[1]] = q4
    qw[-1] = torch.from_numpy(wide).to(q4.device)
    lw = l4.clone()
    lw[-1] = WIDE_BP
    this = loop_launcher("forward_p3", fm, qw, lw, ones, msl, mi)
    this()
    torch.cuda.synchronize()
    time_turns(f"forward_p3 phase 14c's wide read last in phase 4's first "
               f"microbatch (B={len(qw)}, L={WIDE_BP}, int32)", libs,
               "forward_p3", fm, (qw, lw, ones, msl, mi), 3, WIDE_BP,
               this.out, "base of the wide read")
    time_turns("forward_p3 phase 14c's wide read alone", libs, "forward_p3",
               fm, (qw[-1:].contiguous(), lw[-1:].contiguous(), ones[:1],
                    msl, mi), 3, WIDE_BP,
               tuple(type(t)(*(f[-1:] for f in t)) for t in this.out),
               "base")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def turn_inputs(args, knobs: "dict | None" = None,
                capture: str = "4") -> tuple:
    """The inputs of the turn modes: the card's name and power limit, the
    genome, then a PE run through the CLI on TURN_PAIRS pairs under knobs
    that captures its first microbatch (Spy capture "4": the forward and
    SA inputs; "11": the first two v8 passes). Returns (chromosome, int32
    index, int64 index of the same genome, the spy)."""
    import _torch_toy
    from mpibwa_tpu_torch.index.format import load_index
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    torch.cuda.set_device(0)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=True,
                       capture_output=True, text=True,
                       timeout=60).stdout.strip())
    ref, chrom = build_genome(args.seed, args.genome_bp)
    work = os.path.join(REPO, "build", "turns")
    r1, r2 = _torch_toy.simulate_pairs({"chr1": chrom}, TURN_PAIRS,
                                       seed=args.seed + 1)
    fq = [os.path.join(work, f"r{i}.fq") for i in (1, 2)]
    os.makedirs(work, exist_ok=True)
    for path, reads in zip(fq, (r1, r2)):
        write_reads(path, reads)
    spy = Spy()
    run_cli(os.path.join(work, "pe"), ["-t", "1", "-o", "out", ref] + fq,
            spy, "device", knobs, capture)
    fm = spy.runtimes[-1].aligners[0].dfm
    spy.close()
    fm64 = DeviceFMIndex(load_index(ref), fm.o2_tables().device,
                         force_wide=True)
    return chrom, fm, fm64, spy


def sa_turns(args) -> int:
    """--sa-turns DIR ...: kernel 6 of this checkout against the builds of
    other sa_walk.cu sources with the same C entry point (an earlier
    design, another block shape), on one card: the first SA prefetch of a
    PE run on TURN_PAIRS pairs plus phase 2g's edge indices, at both
    position types, on phase 2g's sets (a)-(d), after phase 2g's probe.
    Every build is held to the plain _sa_lookup16 on each set, then all
    are timed in turns."""
    from mpibwa_tpu_torch.ops.fmd import _sa_lookup16

    libs = build_turn_libs(args.sa_turns, "sa_walk")
    _, fm, fm64, spy = turn_inputs(args)
    latency_probe(fm)
    for idx in (fm, fm64):
        ks = sa_edge_ks(fm, spy.sa_ks).to(idx.idt)
        plain = functools.partial(_sa_lookup16, idx.o2_tables(), idx.L2,
                                  idx.primary, idx.seq_len, idx.sa,
                                  idx.sa_intv)
        st = {}
        plain(ks, stats=st)
        for name, what, sub in sa_sets(ks, st["walk_steps"]):
            sst = {}
            want = plain(sub, stats=sst)
            time_turns(f"sa_walk set ({name}) {what} (N={len(sub)}, "
                       f"{idx.idt}, {sst['rounds']} rounds, {sst['steps']} "
                       f"steps)", libs, "sa_walk", idx, (sub,), 20,
                       sst["rounds"], want, "round", cold=True)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# -- --v8-turns: kernel 7 against other builds, in turns ----------------------

# the C entry point of the slotted kernel 7 (one warp a lane, S slots of
# 32 entries in registers), before the packed layout: its arguments after
# DeviceFMIndex.o2_args(), and its register instances
SLOTTED_V8_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 6)
SLOTTED_V8_SLOTS = (4, 8)


def v8_launcher(lib, src: str, max_len):
    """A launch function (fm, inputs, outputs) of the bwd_v8 library lib
    built from src: this checkout's C entry point (v8_cuda.v8_launch), or
    the slotted kernel's where src's signature takes a slot count (its
    instance picked from the seeder's max_len, as its wrapper did)."""
    from mpibwa_tpu_torch.ops import v8_cuda as V
    from mpibwa_tpu_torch.ops.bwd_cuda import slot_count
    from mpibwa_tpu_torch.ops.seeding import F_CAP

    slots = slot_count(F_CAP if max_len is None else max_len,
                       SLOTTED_V8_SLOTS)
    fn = getattr(lib, "mpibwa_bwd_v8")
    with open(src) as fh:
        slotted = re.search(r"int E, int slots", fh.read()) is not None
    fn.argtypes = (V.ENTRY[2] if not slotted
                   else V.ENTRY[2][:6] + SLOTTED_V8_ARGS)
    fn.restype = ctypes.c_int

    def launch(fm, inp, out):
        if not slotted:
            rc = V.v8_launch(fm, inp, out, fn)
        else:
            from mpibwa_tpu_torch.ops import _build

            NL, L = inp.q.shape
            rc = _build.launch_on(
                inp.q.device, fn, *fm.o2_args(), inp.q.data_ptr(), NL, L,
                inp.lane_off.data_ptr(), inp.x0.data_ptr(),
                inp.minv.data_ptr(), inp.ik.data_ptr(), inp.live.data_ptr(),
                inp.ik.shape[0], slots,
                out.k0.data_ptr(), out.s.data_ptr(), out.i.data_ptr(),
                out.flags.data_ptr(), out.ctl.data_ptr())
        if rc != 0:
            raise Failed(f"turns: a launch of {src} failed (cudaError {rc})")
    return launch


def retyped(call, idx) -> tuple:
    """A captured v8 pass (v8_capture) on index idx: its intervals in
    idx's position type."""
    fm, qrows, (ik, info, lane, live), *rest = call
    return (idx, qrows, (ik.to(idx.idt), info, lane, live), *rest)


def v8_turn(tag: str, call, libs: dict, srcs: dict, rate: float) -> None:
    """One pass of v8_turns (call: v8_capture's tuple): step 0's counts,
    every build held to the plain v8 and to v8_trace, then timed in turns:
    the kernel alone, the wrapper's route around it (v8_rows: the inputs,
    the launch, the rows' compaction and pull), and the host's wall in
    the inputs and in the launch call."""
    from mpibwa_tpu_torch.ops import backward8 as B8
    from mpibwa_tpu_torch.ops import v8_cuda as V

    idx, qrows, entry, NL, x0, minv, min_len, max_len, est = call
    inp = V.v8_inputs(idx, qrows, entry, NL, x0, minv)
    launchers = {k: v8_launcher(lib, srcs[k], max_len)
                 for k, lib in libs.items()}
    tr = v8_trace(idx, inp)
    what = (f"the first {tag} backward of a v8 PE run (E="
            f"{entry[0].shape[0]}, {int(entry[3].sum())} live "
            f"entries, NL={NL}, L={qrows.shape[1]}, {idx.idt}, "
            f"{tr['rounds']} rounds)")
    v8_counts(what, inp, tr, rate)
    want, _ = B8.run_backward8(idx, qrows, entry, NL, x0, minv,
                               min_len=min_len, raw=True,
                               est_rows=est)
    want = V.lane_order(want)
    gos, wr = {}, {}
    used = int(inp.lane_off[-1])
    for k, launch in launchers.items():
        got, _ = V.v8_rows(idx, qrows, entry, NL, x0, minv, min_len,
                           True, est, None, None, launch)
        out = V.v8_outputs(idx, entry[0].shape[0], qrows.device)
        gos[k] = functools.partial(launch, idx, inp, out)
        gos[k].keep = (inp.q,)
        gos[k]()
        torch.cuda.synchronize()
        err = max([rows_err(got, want)] + [
            max_err(getattr(out, f)[:used], v)
            for f, v in tr["final"].items()])
        if err:
            raise Failed(f"turns {what}: {k} differs ({err})")
        wr[k] = int(out.ctl[3])
    order = list(gos)
    warm = {k: [] for k in order}
    cold = {k: [] for k in order}
    route = {k: [] for k in order}
    host = {k: [] for k in order}
    for k in order + order[::-1]:
        warm[k].append(launch_ms(gos[k], 20))
        cold[k].append(cold_ms(gos[k]))
        route[k].append(median_ms(functools.partial(
            V.v8_rows, idx, qrows, entry, NL, x0, minv, min_len, True, est,
            None, None, launchers[k]), 21))
        host[k].append((host_ms(functools.partial(
            V.v8_inputs, idx, qrows, entry, NL, x0, minv), 21),
            host_ms(gos[k], 21)))
    log(f"turns bwd_v8 {what}: every build max_abs_err=0 against "
        f"the plain v8 ({len(want)} rows) and the trace ({used} "
        f"entries' outputs); warp-rounds (the kernel's count) "
        + ", ".join(f"{k} {v}" for k, v in wr.items() if v)
        + f"; in turns, kernel alone "
        f"(CUDA events), ms 20 launches back to back (median of 3) "
        f"| one launch with the L2 flushed (median of 11) | the wrapper's "
        f"route, v8_rows (median of 21) | the host's wall in its inputs "
        f"(v8_inputs) and in the launch call (median of 21): "
        + "; ".join(f"{k} {' / '.join(f'{t:.4f}' for t in warm[k])}"
                    f" | {' / '.join(f'{t:.4f}' for t in cold[k])}"
                    f" | {' / '.join(f'{t:.4f}' for t in route[k])}"
                    f" | {' / '.join(f'{a:.4f}, {b:.4f}' for a, b in host[k])}"
                    for k in order))


def v8_turns(args) -> int:
    """--v8-turns [DIR ...]: kernel 7 of this checkout against the builds
    of other bwd_v8.cu sources (an earlier design: the slotted kernel
    takes its own C entry point, v8_launcher), on one card: the first
    pass-1 and pass-2 backward of a PE run under MPIBWA_BWD=v8 on
    TURN_PAIRS pairs (one microbatch, the first of phase 11's and of phase
    2i's runs), at both position types, after phase 2g's probe. On each:
    step 0's counts (v8_counts), then every build held to the plain torch
    v8 (rows in lane order, every column) and to v8_trace entry by entry,
    then all timed in turns A B .. B A, 20 launches back to back and one
    with the L2 flushed. With no DIR this checkout's build alone."""
    libs = build_turn_libs(args.v8_turns, "bwd_v8")
    srcs = {d: os.path.join(d, "bwd_v8.cu") for d in args.v8_turns}
    srcs["this"] = os.path.join(REPO, "mpibwa_tpu_torch", "csrc",
                                "bwd_v8.cu")
    _, fm, fm64, spy = turn_inputs(args, {"MPIBWA_BWD": "v8"}, "11")
    if len(spy.v8_calls) < 2:
        raise Failed("turns: the run made fewer than two v8 passes")
    _, rate = latency_probe(fm)
    for tag, call in zip(("pass 1", "pass 2"), spy.v8_calls):
        for idx in (fm, fm64):
            v8_turn(tag, retyped(call, idx), libs, srcs, rate)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
        r = run_cli(d, argv, spy, "device", capture="14a" if preset else None)
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


def wide_read(codes, seed) -> np.ndarray:
    """Phase 14c's wide read: WIDE_BP codes off the genome where it holds
    no N, with 0.1% substitutions."""
    import _torch_toy as toy

    rng = np.random.default_rng(seed)
    while True:
        start = int(rng.integers(0, len(codes) - WIDE_BP))
        if not (codes[start: start + WIDE_BP] >= 4).any():
            break
    return toy.substituted(rng, codes[start: start + WIDE_BP], 0.001)


def wide_batch(work, codes, short_reads, seed) -> "tuple[str, str, int]":
    """Phase 14c's FASTQ files (the short reads alone, and the short reads
    with the wide read last) and the short reads' count: phase 7's first
    WIDE_BATCH - 1 SE reads and a WIDE_BP read off the genome (0.1%
    substitutions, no N)."""
    import _torch_toy as toy

    wide = wide_read(codes, seed)
    short = list(short_reads[: WIDE_BATCH - 1])
    fq_s = os.path.join(work, "wide_short.fq")
    fq_w = os.path.join(work, "wide.fq")
    write_reads(fq_s, short)
    write_reads(fq_w, short + [("wide", toy.to_bases(wide))])
    return fq_s, fq_w, len(short)


def _die_with_parent(parent: int) -> None:
    """In a side process: the kernel kills it when its parent dies (prctl
    PR_SET_PDEATHSIG), however the parent ends; if the parent is already
    gone, exit now."""
    ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)
    if os.getppid() != parent:
        sys.exit(1)


def start_plain_wide(ref: str, fq: str, out: str) -> subprocess.Popen:
    """The plain forward_p3 over the wide read of phase 14c's batch alone
    (the last read of fq, at the batch's width), on the CPU in a side
    process (this script with --plain-wide), so that its 62,708 host-loop
    rounds overlap the phases after 15 instead of adding to the run. A
    lane's outputs do not depend on the other lanes, so phase 2g holds the
    kernel over the whole batch to the plain loop over its other lanes (on
    the card) with what this process writes to out put in at the wide
    read's lane (wide_lane, splice_lane). In process on
    an H100 80GB HBM3 (700 W) the wide lane's rounds took 320 s (5.1 ms a
    round); the whole batch on one CPU thread did not end in 600 s."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    with open(out + ".log", "w") as fh:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--plain-wide", ref,
             fq, out, str(os.getpid())], env=env, stdout=fh,
            stderr=subprocess.STDOUT)


def plain_wide(ref: str, fq: str, out: str, parent: str) -> int:
    """--plain-wide: ops/seeding.forward_p3 on the CPU over the last read
    of fq (B = 1), padded as the seeder pads it; its outputs, seconds and
    steps (extend1_fwd calls, over-steps included) saved to out."""
    _die_with_parent(int(parent))
    from mpibwa_tpu_torch.core.opts import mem_opt_init
    from mpibwa_tpu_torch.io.fastq import read_fastq
    from mpibwa_tpu_torch.ops import seeding
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.pipeline.device_seed import _pad_batch

    torch.set_num_threads(1)
    fm = DeviceFMIndex(host_index(ref), "cpu")
    q, lens = _pad_batch([s.seq for s in read_fastq(fq)[-1:]])
    opt = mem_opt_init()
    steps = [0]
    real = DeviceFMIndex.extend1_fwd

    def ext1(*a):
        steps[0] += 1
        return real(*a)

    DeviceFMIndex.extend1_fwd = ext1
    t = time.perf_counter()
    fwd, p3 = seeding.forward_p3(
        fm, torch.from_numpy(q), torch.from_numpy(lens),
        torch.ones(len(q), dtype=torch.int64), opt.min_seed_len,
        opt.max_mem_intv)
    arrays = {f"fwd_{n}": v.numpy() for n, v in zip(fwd._fields, fwd)}
    arrays.update({f"p3_{n}": v.numpy() for n, v in zip(p3._fields, p3)})
    np.savez(out, seconds=time.perf_counter() - t, steps=steps[0],
             **arrays)
    return 0


def phase14_wide(work, ref, fq_s, fq_w, n_short, spy, smi) -> None:
    """14c: wide_batch's reads under MPIBWA_EXT=device: every short read's
    lines equal a run on the short reads alone, the wide read's equal the
    host spec engine's at its read id; the call words are int64 and every
    pass launch reads its query row in place."""
    from mpibwa_tpu_torch.core.fm import FMIndex
    from mpibwa_tpu_torch.core.pipeline import process_seqs
    from mpibwa_tpu_torch.core.refseq import RefSeq
    from mpibwa_tpu_torch.io.fastq import read_fastq
    from mpibwa_tpu_torch.pipeline.device_align import DeviceAligner

    # the extension callback's time, summed over the C sessions' threads
    count = {"ext_rows_s": 0.0}
    real = DeviceAligner._ext_rows

    def ext_rows(al, *a, **k):
        t = time.time()
        try:
            return real(al, *a, **k)
        finally:
            count["ext_rows_s"] += time.time() - t

    DeviceAligner._ext_rows = ext_rows
    try:
        r = run_cli(os.path.join(work, "wide"), ["-t", "1", "-o", "out",
                                                 ref, fq_w], spy, "device",
                    capture="14c")
    finally:
        DeviceAligner._ext_rows = real
    widths, dtypes = list(spy.pass_widths), set(spy.word_dtypes)
    report_run("phase 14c wide batch", r, n_short + 1)
    require_c_chain("phase 14c", r)
    st = r["seed_times"]
    log(f"phase 14c on {smi}: {n_short} reads of phase 7 and one "
        f"{WIDE_BP}-bp read last; call words {sorted(map(str, dtypes))}; "
        f"{len(widths)} pass launches, query rows {sorted(set(widths))} bp "
        f"(Lp = 0, read in place, past 12,288: "
        f"{all(w > 12_288 for w in widths)}); fwd1 "
        f"{st.get('fwd1', 0.0):.3f} s (its forward steps: phase 2g); "
        f"_ext_rows {count['ext_rows_s']:.3f} s summed over the C sessions' "
        f"threads; kernel launches {r['launches']}; peak device memory "
        f"{r['peak'] / 2**30:.3f} GiB")
    for k in MAIN_KERNELS:
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
             absent=(), capture=None):
    """A main-path run under knobs: each of its kernels launched, none of
    the absent ones, its SAM equal to base_sam (phase 4's); capture: the
    spy's tag for the run."""
    r = run_cli(workdir, argv, spy, "device", knobs, capture)
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
            f"kernel launches {r['launches']['bwd_pass']}, v8 kernel "
            f"launches {r['launches']['bwd_v8']}, peak device memory "
            f"{r['peak'] / 2**30:.3f} GiB")


def phase15(work, argv, spy, base_sam, n_reads) -> None:
    """The default in three turns (kernels, plain loops, kernels): in the
    middle one the seeder's forward automata and SA walks run their plain
    versions (Spy.plain, not a knob). Every SAM equal to phase 4's; the
    kernel turns launch the three loop kernels and call no plain loop, the
    plain turn the reverse. fwd1, p2_fwd and the SA walk (its calls timed
    between two synchronizes, summed) of each turn."""
    turns = []
    for i, plain in enumerate((False, True, False)):
        what = "plain loops" if plain else "kernels"
        tag = f"phase 15 turn {i + 1} ({what})"
        spy.plain, spy.time_sa = plain, True
        try:
            r = run_cli(os.path.join(work, f"pe_loops{i}"), argv, spy,
                        "device")
        finally:
            spy.plain, spy.time_sa = False, False
        require_c_chain(tag, r)
        n = [r["launches"][k] for k in LOOP_KERNELS]
        ok = (r["sam"] == base_sam
              and (r["plain_calls"] > 0 and not any(n) if plain
                   else r["plain_calls"] == 0 and all(n)))
        st = r["seed_times"]
        log(f"{tag}: {backward_stages(r, n_reads)}; SA walk "
            f"{r['sa_s']:.3f} s over {r['sa_calls']} calls (a synchronize "
            f"before and after each); loop kernel launches "
            f"{dict(zip(LOOP_KERNELS, n))}, plain loop calls "
            f"{r['plain_calls']}; SAM == phase 4's: {r['sam'] == base_sam}")
        if not ok:
            raise Failed(f"{tag}: wrong SAM or wrong route")
        turns.append((st.get("fwd1", 0.0), st.get("p2_fwd", 0.0), r["sa_s"],
                      r["align"]))
    log("phase 15 kernels / plain loops / kernels: " + "; ".join(
        f"{name} {' / '.join(f'{t[j]:.3f}' for t in turns)} s"
        for j, name in enumerate(("fwd1", "p2_fwd", "SA walk", "align"))))


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
    ap.add_argument("--fwd-turns", nargs="+", metavar="DIR",
                    help="time kernels 4 and 5 against the fwd_automata.cu "
                         "of each DIR, in turns (fwd_turns), and stop")
    ap.add_argument("--sa-turns", nargs="+", metavar="DIR",
                    help="time kernel 6 against the sa_walk.cu of each "
                         "DIR, in turns (sa_turns), and stop")
    ap.add_argument("--v8-turns", nargs="*", metavar="DIR",
                    help="step 0's counts of kernel 7 and its time against "
                         "the bwd_v8.cu of each DIR, in turns (v8_turns), "
                         "and stop")
    ap.add_argument("--plain-wide", nargs=4,
                    metavar=("REF", "FQ", "OUT", "PARENT_PID"),
                    help="the side process of phase 2g (plain_wide)")
    args = ap.parse_args()
    if args.plain_wide:
        sys.path.insert(0, REPO)
        return plain_wide(*args.plain_wide)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        if args.fwd_turns or args.sa_turns or args.v8_turns is not None:
            sys.path.insert(0, REPO)
            sys.path.insert(0, os.path.join(REPO, "tests"))
            return (fwd_turns(args) if args.fwd_turns else sa_turns(args)
                    if args.sa_turns else v8_turns(args))
        return smoke(args)
    finally:
        for proc in SIDE:  # stop every side process, whatever happened
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def smoke(args) -> int:
    """Every phase, in order; returns 0 or raises Failed."""
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
                 base + [paths["r1"], paths["r2"]], spy, "device",
                 capture="4")
    n_pe = 2 * args.pairs
    mapped = check_sam(pe["sam"], n_pe)
    launches = {k: pe["launches"][k] for k in MAIN_KERNELS}
    report_run("phase 4 PE device", pe, n_pe)
    require_c_chain("phase 4", pe)
    log(f"phase 4 mapped share {mapped:.4f}; plain loops called "
        f"{pe['plain_calls']} times")
    for k in MAIN_KERNELS:
        report_sizes("phase 4", pe, k)
        if launches[k] <= 0:
            raise Failed(f"the main path launched no {k} kernel")
    if pe["launches"]["bwd_v8"]:
        raise Failed("the default run on the int32 index launched the v8 "
                     "kernel")
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
    for k in MAIN_KERNELS:
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
                  ["occ4_extend"], pe["sam"], n_pe,
                  absent=["bwd_pass", "bwd_v8"])
    launches["occ4_extend"] = r8["launches"]["occ4_extend"]
    report_sizes("phase 8", r8, "occ4_extend")
    # phase 9: flat, contig, the default, v8 (phase 11), the default, in
    # turns after phase 8
    r9f = knob_run("phase 9 PE MPIBWA_BWD=flat", os.path.join(work, "pe_flat"),
                   pe_argv, spy, {"MPIBWA_BWD": "flat"}, ["extend"],
                   pe["sam"], n_pe, absent=["bwd_pass", "bwd_v8"])
    # the contig engine (opt-in, no kernel of its own)
    r9c = knob_run("phase 9 PE MPIBWA_BWD=contig",
                   os.path.join(work, "pe_contig"), pe_argv, spy,
                   {"MPIBWA_BWD": "contig"}, ["extend"], pe["sam"], n_pe,
                   absent=["bwd_pass", "bwd_v8"])
    r9d = knob_run("phase 9 PE default", os.path.join(work, "pe_default"),
                   pe_argv, spy, {}, MAIN_KERNELS, pe["sam"], n_pe,
                   absent=["bwd_v8"])
    report_sizes("phase 9 default", r9d, "bwd_pass")
    # phase 11: the v8 engine on the main path, each pass one launch of
    # kernel 7
    r11 = knob_run("phase 11 PE MPIBWA_BWD=v8", os.path.join(work, "pe_v8"),
                   pe_argv, spy, {"MPIBWA_BWD": "v8"}, ["extend", "bwd_v8"],
                   pe["sam"], n_pe, absent=["bwd_pass"], capture="11")
    launches["bwd_v8"] = r11["launches"]["bwd_v8"]
    report_sizes("phase 11", r11, "bwd_v8")
    log(f"phase 11 v8: {backward_stages(r11, n_pe)}")
    r9d2 = knob_run("phase 9 PE default again",
                    os.path.join(work, "pe_default2"), pe_argv, spy, {},
                    MAIN_KERNELS, pe["sam"], n_pe, absent=["bwd_v8"])
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
    # phase 15: the default with the three loops' plain versions, in turns
    phase15(work, pe_argv, spy, pe["sam"], n_pe)
    # phase 14c's batch, and the plain loop over it in a side process
    fq_s, fq_w, n_short = wide_batch(work, codes, r1l, args.seed + 3)
    wide_out = os.path.join(work, "plain_wide.npz")
    side = start_plain_wide(ref, fq_w, wide_out)
    SIDE.append(side)
    # phases 12 and 13: the record route and the launcher on the first pairs
    phase12(work, base, paths, spy, default_sam, args.host_pairs, smi)
    phase13(work, ref, paths, spy, args.host_pairs)
    # phase 14: long and wide reads
    phase14_long(work, ref, codes, spy, args.long_reads, args.seed + 2, smi)
    phase14_wide(work, ref, fq_s, fq_w, n_short, spy, smi)
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
            (MAIN_KERNELS, "default", "pe_device_traced", {}),
            (["occ4_extend"], "phase 8", "pe_occ4_traced", knobs8),
            (["bwd_v8"], "phase 11", "pe_v8_traced", {"MPIBWA_BWD": "v8"})):
        got = profiled_run(f"phase 10 ({ph})", os.path.join(work, d),
                           t_argv, spy, kn, kernels, base_sam)
        base_sam = got.pop("sam")
        traced.update(got)
    fm = spy.runtimes[-1].aligners[0].dfm  # phase 8's index, on the card
    spy.close()
    if (spy.occ4_ik is None or spy.bwd_call is None
            or spy.rows_call is None or len(spy.v8_calls) < 2):
        raise Failed("no occ4 batch or backward call captured from the main "
                     "path")

    # phase 2b: kernel 1 on the problems of the main path
    from mpibwa_tpu_torch.ops.extend_batch import extend_batch

    if not captured:
        raise Failed("no extension problems captured from the main path")
    ext = {}
    for i, call in enumerate(captured):
        err = extend_err(call, PEN)
        worst = max(worst, err)
        ms = extend_ms(call, PEN, 7)
        B, Q, T = call[0].shape[0], call[0].shape[1], call[1].shape[1]
        line = (f"phase 2b captured call B={B} Q={Q} T={T}: max_abs_err="
                f"{err}; kernel {ms:.4f} ms (median of 7 after a warm-up, "
                f"CUDA events)")
        if i == 0:
            plain_ms = median_ms(lambda: extend_batch(*call, *PEN), 7)
            b_ms, b_by, cells = extend_bound(call)
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
    fm64 = phase2e(ref, fm, [s for pair in zip(
        _torch_toy.load_reads(paths["r1"], limit=WIDE_READS // 2),
        _torch_toy.load_reads(paths["r2"], limit=WIDE_READS // 2))
        for s in pair])
    # phase 2i: the int64 main path end to end, in process
    for tag, reads in (("i1", r1l[:INPROC_PAIRS]), ("i2", r2l[:INPROC_PAIRS])):
        paths[tag] = os.path.join(work, tag + ".fq")
        write_reads(paths[tag], reads)
    call64, launches64 = phase2i(work, ref, fm, fm64, paths, smi)
    v8_calls = {"int32": spy.v8_calls[0], "int64": call64,
                "int32 pass 2": spy.v8_calls[1]}
    phase2f(spy.rows_call, pe["seed_times"])
    results.update(phase2g(fm, fm64, spy, launches, side, wide_out,
                           v8_calls))
    del fm64, v8_calls
    spy.v8_calls.clear()
    # kernel 7's numbers come from three runs: say which field is whose
    results["bwd_v8"].update(launches_int64=launches64, fields_from={
        "launches": "phase 11: the CLI PE run under MPIBWA_BWD=v8, int32 "
                    "index",
        "run_ms, run_launches, run_pairs": "phase 10: phase 11's run "
                                           "traced, int32 index",
        "launches_int64": f"phase 2i: DeviceAligner on {INPROC_PAIRS} pairs "
                          f"over the int64 index (MPIBWA_BWD=auto)",
        "ms, cold_ms, call_ms, plain_ms, bound_ms, bound_by, "
        "latency_floor_ms": "phase 2g: phase 2i's first pass-1 backward, "
                            "int64 index",
        "int32": "phase 2g: phase 11's first pass-1 backward, int32 index",
        "int32_pass2": "phase 2g: phase 11's first pass-2 backward, int32 "
                       "index",
        "warp_rounds, live_thread_share, random_load_floor_ms": "phase 2g: "
            "the kernel's warp-rounds (its ctl[3]), the trace's steps over "
            "32 threads a warp-round, the steps' sector loads at the "
            "probe's full-card rate",
        "max_abs_err": "phase 2g: those three passes against the plain "
                       "torch v8 and the trace"})
    phase2h(dev, args.seed + 5, smi)

    log(f"total {time.time() - t_start:.1f}s")
    # no single PyTorch call computes any of the seven functions
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
