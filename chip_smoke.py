#!/usr/bin/env python3
"""Drive the torch port's main path once on one NVIDIA GPU and check it.

Phases, one printed line (or more) each:
  1. the card's name and power limit (nvidia-smi);
  2. the three CUDA kernels (mpibwa_tpu_torch/csrc/extend.cu,
     occ4_extend.cu, bwd_round.cu) built from the checkout, one nvcc each,
     all started together; then the extension kernel held against its
     plain PyTorch version on random problems at every window bucket
     (exact equality), and later (2b) on the problems captured from phase
     4, where both are timed with CUDA events (median of 7 runs after a
     warm-up) and the DP cells the problems visit are counted;
  3. a synthetic genome the length of GRCh38 chr1 (248,956,422 bp) with
     N holes and planted repeats, indexed with index/build.py and cached
     under build/genome/ by seed and size;
  4. `mpibwa_tpu_torch.cli mem -t 1` with MPIBWA_EXT=device on simulated
     101-bp pairs (kernel launch counts reset just before);
  5. the same run with MPIBWA_EXT=native (every DP in C): the SAM must be
     byte-identical to phase 4's;
  6. the first pairs through the host spec engine (core/,
     Runtime(use_device=False)): byte-identical to the port's SAM on the
     same file;
  7. phases 4 and 6 for SE reads (R1);
  8. phase 4's run with MPIBWA_PALLAS=1 (every flat backward round extends
     through the fused occ4 kernel): SAM byte-identical to phase 4's;
  9. phase 4's run with MPIBWA_BWD=pallas (the backward passes as fused
     rounds in the round kernel): SAM byte-identical to phase 4's;
  2c. the occ4 kernel against its plain version (exact equality) on seeded
     intervals over the index, both directions, E in {1,000, 65,536,
     1,048,576}, and on the largest batch captured from phase 8; kernel,
     plain version and the O2 `extend` timed (medians of 5, CUDA events);
  2d. the round kernel against its plain round, round by round over the
     entry state captured from phase 9's first backward call (all seven
     state arrays equal after every round, and the emitted mems); a whole
     pass of each timed (medians of 5), given per launch.
Every launch count is set to 0 just before a run of the main path and read
just after. Each kernel's bound is the larger of its bytes over 3.35 TB/s
and its integer operations over 33.5 TOP/s (int32 runs on half the lanes
of the card's 67 TFLOP/s float32 rate). Then a JSON line of kernel results,
and last
{"ok": true, "device": {"platform": "gpu", ...}}.

Usage: python3 chip_smoke.py [--pairs N] [--host-pairs N] [--genome-bp N]
                             [--seed S]
Exits non-zero without a usable CUDA device, on any mismatch and on any
error.
"""

from __future__ import annotations

import argparse
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
    "bwd_round": {"name": "bwd_round", "route": "cuda",
                  "source": "mpibwa_tpu_torch/csrc/bwd_round.cu",
                  "replaces": "mpibwa_tpu/ops/pallas_bwd.py:242"},
}
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


def kernel_vs_plain(args, mat) -> int:
    """Max abs difference over the six outputs (0 = exact)."""
    from mpibwa_tpu_torch.ops.extend_batch import extend_batch
    from mpibwa_tpu_torch.ops.extend_cuda import extend_batch_kernel

    got = torch.stack(list(extend_batch_kernel(*args, mat, *PEN)))
    torch.cuda.synchronize()
    want = torch.stack(list(extend_batch(*args, mat, *PEN)))
    return int((got.long() - want.long()).abs().max())


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


def time_both(args, mat, reps: int) -> "tuple[float, float]":
    """(kernel ms, plain ms): medians of reps CUDA-event timings each."""
    from mpibwa_tpu_torch.ops.extend_batch import extend_batch
    from mpibwa_tpu_torch.ops.extend_cuda import extend_batch_kernel

    return (median_ms(lambda: extend_batch_kernel(*args, mat, *PEN), reps),
            median_ms(lambda: extend_batch(*args, mat, *PEN), reps))


def bound(nbytes: float, ops: float) -> "tuple[float, str]":
    """(least ms the card could take, which side sets it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def extend_bound(args, mat) -> "tuple[float, str, int]":
    """Bound of one extension call: the DP cells these problems visit
    (counted in the plain version) as integer operations, against the bytes
    of the windows, lengths, params and outputs, each once, plus the eh
    scratch rows written once and read once."""
    from mpibwa_tpu_torch.ops.extend_batch import extend_batch

    stats = {}
    extend_batch(*args, mat, *PEN, stats=stats)
    cells = int(stats["cells"])
    qs, ts, qlens, tlens, params = args
    B, Q = qs.shape
    eh = 2 * (Q + 1) * B * 4
    nbytes = (qs.numel() + ts.numel() + 4 * (qlens.numel() + tlens.numel()
                                             + params.numel() + 25)
              + 6 * B * 4 + 2 * eh)
    return bound(nbytes, cells * OPS_PER_DP_CELL) + (cells,)


def phase2_random(rng, dev, mat) -> int:
    from mpibwa_tpu_torch.ops import _build

    t0 = time.time()
    _build.load_all(list(KERNELS))
    log(f"phase 2 build: nvcc sm_90a, {len(KERNELS)} sources side by side, "
        f"{time.time() - t0:.2f}s")
    for name in KERNELS:
        regs = [ln.strip()
                for ln in _build.build_logs.get(name, "").splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"phase 2 build {name}: "
            + ("; ".join(regs) or "library already built under build/kernels"))
    worst = 0
    for (Q, T), B in [(b, 4096) for b in BUCKETS] + [((128, 256), 65536)]:
        args = random_problems(rng, B, Q, T, dev)
        err = kernel_vs_plain(args, mat)
        ms, plain_ms = time_both(args, mat, 5)
        log(f"phase 2 random problems Q={Q} T={T} B={B}: max_abs_err={err}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 5 "
            f"after a warm-up, CUDA events)")
        worst = max(worst, err)
    if worst:
        raise Failed("kernel disagrees with its plain version")
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
    largest B) for phase 2b, the largest occ4 batch for phase 2c and the
    first fused backward call for phase 2d. The launch counts stay on the
    wrappers themselves."""

    def __init__(self):
        from mpibwa_tpu_torch.ops import bwd_cuda, extend_cuda, occ4_cuda
        from mpibwa_tpu_torch.parallel.runtime import Runtime

        self.runtimes = []
        self.captured = []
        self.occ4_ik = None
        self.bwd_call = None
        self._lock = threading.Lock()
        self._mods = (extend_cuda, occ4_cuda, bwd_cuda)
        self._real = extend_cuda.extend_batch_kernel
        self._real_occ4 = occ4_cuda.extend_kernel
        self._real_bwd = bwd_cuda.run_backward_fused
        self.wrappers = {"extend": extend_cuda.extend_batch_kernel,
                         "occ4_extend": occ4_cuda.extend_kernel,
                         "bwd_round": bwd_cuda.bwd_round_kernel}
        self._rt_init = Runtime.__init__
        spy = self

        def rt_init(rt, *a, **k):
            spy._rt_init(rt, *a, **k)
            spy.runtimes.append(rt)

        def capture(qs, ts, qlens, tlens, params, mat, *pen):
            out = spy._real(qs, ts, qlens, tlens, params, mat, *pen)
            with spy._lock:
                spy.captured.append(
                    [x.clone() for x in (qs, ts, qlens, tlens, params)]
                    + [mat])
                spy.captured.sort(key=lambda c: -c[0].shape[0])
                del spy.captured[2:]
            return out

        def capture_occ4(fm, ik, is_back):
            with spy._lock:
                if is_back and (spy.occ4_ik is None
                                or ik.shape[0] > spy.occ4_ik.shape[0]):
                    spy.occ4_ik = ik.clone()
            return spy._real_occ4(fm, ik, is_back)

        def capture_bwd(fm, qrows, entry, n_lanes, x0, minv, lane_off, **k):
            with spy._lock:
                if spy.bwd_call is None:
                    spy.bwd_call = (qrows.clone(),
                                    tuple(t.clone() for t in entry),
                                    np.array(x0), np.array(minv),
                                    np.array(lane_off))
            return spy._real_bwd(fm, qrows, entry, n_lanes, x0, minv,
                                 lane_off, **k)

        Runtime.__init__ = rt_init
        extend_cuda.extend_batch_kernel = capture
        occ4_cuda.extend_kernel = capture_occ4
        bwd_cuda.run_backward_fused = capture_bwd

    @property
    def launches(self) -> dict:
        return {name: fn.launches for name, fn in self.wrappers.items()}

    def close(self):
        from mpibwa_tpu_torch.parallel.runtime import Runtime

        Runtime.__init__ = self._rt_init
        extend_cuda, occ4_cuda, bwd_cuda = self._mods
        extend_cuda.extend_batch_kernel = self._real
        occ4_cuda.extend_kernel = self._real_occ4
        bwd_cuda.run_backward_fused = self._real_bwd

    def reset(self):
        for fn in self.wrappers.values():
            fn.launches = 0
        self.runtimes.clear()


def run_cli(workdir: str, argv: "list[str]", spy: Spy, ext: str,
            knobs: "dict | None" = None) -> dict:
    """`cli mem` in workdir with -o out; returns its SAM bytes and stats.
    knobs: MPIBWA_PALLAS / MPIBWA_BWD for this run (unset otherwise)."""
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
    finally:
        os.chdir(cwd)
        for k in knobs or {}:
            os.environ.pop(k, None)
    wall = time.time() - t0
    if rc != 0:
        raise Failed(f"cli mem exited {rc}")
    rt = spy.runtimes[-1]
    al = rt.aligners[0]
    with open(os.path.join(workdir, "out.sam"), "rb") as fh:
        sam = fh.read()
    return {"sam": sam, "wall": wall, "align": rt.times["align"],
            "launches": spy.launches, "stats": al.stats,
            "seed_times": al.seeder.times,
            "peak": torch.cuda.max_memory_allocated()}


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


def host_engine_sam(workdir, ref, r1, r2, argv) -> bytes:
    """The host spec engine (core/) on the same input, with the header the
    CLI writes for argv."""
    from mpibwa_tpu_torch.core import opts as O
    from mpibwa_tpu_torch.core.opts import mem_opt_init, rescale_by_a
    from mpibwa_tpu_torch.index.format import load_index
    from mpibwa_tpu_torch.io import headers as hdr
    from mpibwa_tpu_torch.parallel.runtime import Runtime

    opt = mem_opt_init()
    opt.n_threads = 1
    rescale_by_a(opt, set(), preset=None)
    opt.mat = O.fill_scmat(opt.a, opt.b)
    opt.round_float_fields()
    rt = Runtime(load_index(ref), opt, use_device=False,
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


def phase2c(rng, fm, main_ik) -> dict:
    """occ4 kernel == extend_blocks == the O2 extend; times at every E and
    at the main path's largest batch. Returns the kernels-line numbers."""
    from mpibwa_tpu_torch.ops.occ4_cuda import extend_blocks, extend_kernel

    worst = 0
    res = {}
    cases = [("seeded", seeded_intervals(rng, fm, E))
             for E in (1_000, 65_536, 1_048_576)]
    cases.append(("captured from phase 8 (main path)", main_ik))
    for tag, ik in cases:
        E = ik.shape[0]
        err = 0
        for is_back in (1, 0):
            got = extend_kernel(fm, ik, is_back)
            torch.cuda.synchronize()
            want = extend_blocks(fm, ik, is_back)
            err = max(err, int((got.long() - want.long()).abs().max()))
            if tag == "seeded":  # valid intervals: the O2 path agrees too
                o2 = fm.extend(ik, is_back)
                err = max(err, int((got.long() - o2.long()).abs().max()))
        ms = median_ms(lambda: extend_kernel(fm, ik, 1), 5)
        plain_ms = median_ms(lambda: extend_blocks(fm, ik, 1), 5)
        o2_ms = median_ms(lambda: fm.extend(ik, 1), 5)
        b_ms, b_by = bound(156 * E, OPS_PER_EXTENSION * E)
        log(f"phase 2c occ4 kernel, {tag}, E={E}: max_abs_err={err} (both "
            f"directions); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, O2 "
            f"extend {o2_ms:.4f} ms (medians of 5 after a warm-up, CUDA "
            f"events); bound {b_ms:.5f} ms by {b_by}")
        worst = max(worst, err)
        res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by}
    if worst:
        raise Failed("occ4 kernel disagrees with its plain version")
    return dict(res, max_abs_err=worst)


def phase2d(fm, call) -> dict:
    """Round kernel == bwd_round round by round from the captured entry
    state, and the same mems; a whole pass of each timed, per launch."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    qrows, entry, x0, minv, lane_off = call
    lanes, state0 = BC.entry_state(qrows, entry, x0, minv, lane_off)
    E, NL = state0.shape[1], qrows.shape[0]
    kst, pst = state0.clone(), state0.clone()
    worst = rounds = live_rounds = 0
    while bool(pst[BC.LIVE].any()):
        live_rounds += int(pst[BC.LIVE].sum())
        pst = BC.bwd_round(fm, lanes, pst)
        BC.bwd_round_kernel(fm, lanes, kst)
        torch.cuda.synchronize()
        worst = max(worst, int((kst.long() - pst.long()).abs().max()))
        rounds += 1
        if rounds > qrows.shape[1] + 2:
            raise Failed("backward pass did not end")
    mems_k = BC.pack_emitted(kst, entry[1], lanes.lane_e)
    mems_p = BC.pack_emitted(pst, entry[1], lanes.lane_e)
    if mems_k.shape != mems_p.shape or (mems_k != mems_p).any():
        raise Failed("round kernel and plain round emit different mems")

    def whole_pass(step, copies):
        st = copies.pop()
        for _ in range(rounds):
            st = step(fm, lanes, st)

    reps = 5
    copies = [state0.clone() for _ in range(reps + 1)]
    pass_ms = median_ms(lambda: whole_pass(BC.bwd_round_kernel, copies), reps)
    copies = [state0.clone() for _ in range(reps + 1)]
    plain_pass_ms = median_ms(lambda: whole_pass(BC.bwd_round, copies), reps)
    # a live entry: 7 state words in and out, its query base, min_intv and
    # two 48-byte block rows
    b_ms, b_by = bound(164 * live_rounds / rounds,
                       OPS_PER_EXTENSION * live_rounds / rounds)
    log(f"phase 2d round kernel, entry state of phase 9's first backward "
        f"call: E={E} entries, {NL} lanes, {rounds} rounds, {live_rounds} "
        f"live entry-rounds, {len(mems_k)} mems: max_abs_err={worst} over "
        f"all 7 state arrays after every round, mems equal; whole pass "
        f"kernel {pass_ms:.4f} ms, plain {plain_pass_ms:.4f} ms (medians of "
        f"{reps} after a warm-up, CUDA events) = {pass_ms / rounds:.4f} / "
        f"{plain_pass_ms / rounds:.4f} ms a launch; bound {b_ms:.5f} ms a "
        f"launch by {b_by}")
    if worst:
        raise Failed("round kernel disagrees with its plain round")
    return {"max_abs_err": worst, "ms": pass_ms / rounds,
            "plain_ms": plain_pass_ms / rounds, "bound_ms": b_ms,
            "bound_by": b_by}


def knob_run(tag, workdir, argv, spy, knobs, kernel, base_sam, n_reads):
    """A main-path run under a knob: its kernel launched, its SAM equal to
    phase 4's."""
    r = run_cli(workdir, argv, spy, "device", knobs)
    report_run(tag, r, n_reads)
    same = r["sam"] == base_sam
    log(f"{tag} SAM == phase 4's: {same}")
    if r["launches"][kernel] <= 0:
        raise Failed(f"{tag}: the main path launched no {kernel} kernel")
    if not same:
        raise Failed(f"{tag}: SAM differs from the default run's")
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=50_000)
    ap.add_argument("--host-pairs", type=int, default=1_000)
    ap.add_argument("--genome-bp", type=int, default=248_956_422)
    ap.add_argument("--seed", type=int, default=1)
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
    worst = phase2_random(rng, dev, mat)

    t0 = time.time()
    ref, chrom = build_genome(args.seed, args.genome_bp)
    log(f"phase 3 genome: {args.genome_bp} bp indexed at {ref} in "
        f"{time.time() - t0:.1f}s")

    work = os.path.join(REPO, "build", "smoke")
    r1l, r2l = _torch_toy.simulate_pairs({"chr1": chrom}, args.pairs,
                                         seed=args.seed + 1)
    del chrom
    paths = {}
    for tag, reads in (("r1", r1l), ("r2", r2l), ("h1", r1l[: args.host_pairs]),
                       ("h2", r2l[: args.host_pairs])):
        paths[tag] = os.path.join(work, tag + ".fq")
        os.makedirs(work, exist_ok=True)
        write_reads(paths[tag], reads)

    spy = Spy()
    base = ["-t", "1", "-o", "out", ref]
    # phase 4: the main path, extension DP in the kernel
    pe = run_cli(os.path.join(work, "pe_device"),
                 base + [paths["r1"], paths["r2"]], spy, "device")
    n_pe = 2 * args.pairs
    mapped = check_sam(pe["sam"], n_pe)
    launches = {"extend": pe["launches"]["extend"]}
    report_run("phase 4 PE device", pe, n_pe)
    log(f"phase 4 mapped share {mapped:.4f}")
    if launches["extend"] <= 0:
        raise Failed("the main path launched no extension kernel")
    captured = list(spy.captured)

    # phase 5: every DP scalar in C
    nat = run_cli(os.path.join(work, "pe_native"),
                  base + [paths["r1"], paths["r2"]], spy, "native")
    report_run("phase 5 PE native", nat, n_pe)
    same = nat["sam"] == pe["sam"]
    log(f"phase 5 SAM device == native: {same}")
    if not same:
        raise Failed("MPIBWA_EXT=device and native SAM differ")

    # phase 6: the host spec engine on the first pairs
    hargv = base + [paths["h1"], paths["h2"]]
    port = run_cli(os.path.join(work, "pe_host_port"), hargv, spy, "device")
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
    if se["launches"]["extend"] <= 0:
        raise Failed("the SE main path launched no extension kernel")
    hargv = base + [paths["h1"]]
    port = run_cli(os.path.join(work, "se_host_port"), hargv, spy, "device")
    t0 = time.time()
    host = host_engine_sam(os.path.join(work, "se_host"), ref, paths["h1"],
                           None, hargv)
    same = host == port["sam"]
    log(f"phase 7 SE {args.host_pairs} reads: port == host spec engine: "
        f"{same} (host engine {time.time() - t0:.1f}s)")
    if not same:
        raise Failed("port and host spec engine SAM differ (SE)")

    # phases 8, 9: the main path through the block-layout kernels
    pe_argv = base + [paths["r1"], paths["r2"]]
    r8 = knob_run("phase 8 PE MPIBWA_PALLAS=1", os.path.join(work, "pe_occ4"),
                  pe_argv, spy, {"MPIBWA_PALLAS": "1"}, "occ4_extend",
                  pe["sam"], n_pe)
    launches["occ4_extend"] = r8["launches"]["occ4_extend"]
    r9 = knob_run("phase 9 PE MPIBWA_BWD=pallas", os.path.join(work, "pe_bwd"),
                  pe_argv, spy, {"MPIBWA_BWD": "pallas"}, "bwd_round",
                  pe["sam"], n_pe)
    launches["bwd_round"] = r9["launches"]["bwd_round"]
    fm = spy.runtimes[-1].aligners[0].dfm  # phase 9's index, on the card
    spy.close()
    if spy.occ4_ik is None or spy.bwd_call is None:
        raise Failed("no occ4 batch or backward call captured from the main "
                     "path")

    # phase 2b: the kernel on the problems of the main path
    ms = plain_ms = None
    for i, c in enumerate(captured):
        args, m = c[:5], c[5]
        err = kernel_vs_plain(args, m)
        worst = max(worst, err)
        B, Q, T = args[0].shape[0], args[0].shape[1], args[1].shape[1]
        line = (f"phase 2b captured call B={B} Q={Q} T={T}: "
                f"max_abs_err={err}")
        if i == 0:
            ms, plain_ms = time_both(args, m, 7)
            b_ms, b_by, cells = extend_bound(args, m)
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                     f"(median of 7 after a warm-up, CUDA events); {cells} "
                     f"DP cells visited, bound {b_ms:.5f} ms by {b_by}")
        log(line)
    if worst:
        raise Failed("kernel disagrees with its plain version")
    if not captured:
        raise Failed("no extension problems captured from the main path")

    results = {"extend": {"max_abs_err": worst, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by},
               "occ4_extend": phase2c(rng, fm, spy.occ4_ik),
               "bwd_round": phase2d(fm, spy.bwd_call)}

    log(f"total {time.time() - t_start:.1f}s")
    # no single PyTorch call computes any of the three functions
    log(json.dumps({"kernels": [
        dict(KERNELS[k], launches=launches[k], library_ms=None, **results[k])
        for k in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
