"""Synthetic reference and reads for the torch port's parity tests.

A ~200 kbp genome of two contigs with an N hole and planted 600-bp
repeats (exact and diverged copies), indexed with the repo's own
index/build.py, and simulated 101-bp read pairs with substitutions, small
indels and an insert-size spread. Everything derives from numpy seeds, so
both packages see the same inputs.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

READ_LEN = 101
_COMP = str.maketrans("ACGTN", "TGCAN")


def _mutate(rng, s: str, rate: float) -> str:
    arr = np.array(list(s))
    hit = rng.random(len(arr)) < rate
    arr[hit] = rng.choice(list("ACGT"), int(hit.sum()))
    return "".join(arr)


def make_genome(seed: int = 1) -> "dict[str, str]":
    """Two contigs (120 kbp, 80 kbp); a 400-bp N hole in the first; a
    600-bp unit planted four times exactly and twice at 2% divergence."""
    rng = np.random.default_rng(seed)
    contigs = {name: list("".join(rng.choice(list("ACGT"), n)))
               for name, n in (("chrA", 120_000), ("chrB", 80_000))}
    unit = "".join(rng.choice(list("ACGT"), 600))
    for name, pos, rate in (("chrA", 10_000, 0.0), ("chrA", 50_000, 0.0),
                            ("chrA", 90_000, 0.02), ("chrB", 20_000, 0.0),
                            ("chrB", 45_000, 0.0), ("chrB", 60_000, 0.02)):
        contigs[name][pos: pos + 600] = list(_mutate(rng, unit, rate))
    contigs["chrA"][70_000:70_400] = ["N"] * 400
    return {k: "".join(v) for k, v in contigs.items()}


def write_fasta(path: str, contigs: "dict[str, str]") -> None:
    with open(path, "w") as fh:
        for name, seq in contigs.items():
            fh.write(f">{name} synthetic\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i: i + 70] + "\n")


def _indels(rng, s: str, rate: float) -> str:
    out = []
    for ch in s:
        r = rng.random()
        if r < rate / 2:
            continue  # 1-bp deletion
        out.append(ch)
        if r > 1 - rate / 2:
            out.append("".join(rng.choice(list("ACGT"),
                                          int(rng.integers(1, 4)))))
    return "".join(out)


def simulate_pairs(contigs: "dict[str, str]", n_pairs: int, seed: int = 2,
                   sub_rate: float = 0.01, indel_rate: float = 0.002):
    """n_pairs FR pairs: insert size ~ N(300, 30), R1 on either strand."""
    rng = np.random.default_rng(seed)
    names = list(contigs)
    lens = np.array([len(contigs[n]) for n in names], np.float64)
    r1, r2 = [], []
    for i in range(n_pairs):
        seq = contigs[names[rng.choice(len(names), p=lens / lens.sum())]]
        isize = int(np.clip(rng.normal(300, 30), READ_LEN + 20, 500))
        pos = int(rng.integers(0, len(seq) - isize - 10))
        frag = seq[pos: pos + isize + 10]
        a = frag[: READ_LEN + 5]
        b = frag[isize - READ_LEN - 5: isize].translate(_COMP)[::-1]
        if rng.random() < 0.5:
            a, b = b, a
        reads = []
        for s in (a, b):
            s = _mutate(rng, _indels(rng, s, indel_rate), sub_rate)
            reads.append(s[:READ_LEN])
        r1.append((f"p{i}", reads[0]))
        r2.append((f"p{i}", reads[1]))
    return r1, r2


def write_fastq(path: str, reads) -> None:
    with open(path, "w") as fh:
        for name, s in reads:
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")


def build_toy(directory: str, n_pairs: int = 1000) -> "dict[str, str]":
    """Write toy.fa (+ its bwa index), r1.fq and r2.fq under directory;
    returns their paths. Idempotent per directory."""
    from mpibwa_tpu_torch.index.build import build_index

    paths = {k: os.path.join(directory, f)
             for k, f in (("ref", "toy.fa"), ("r1", "r1.fq"),
                          ("r2", "r2.fq"))}
    if not os.path.exists(paths["r2"]):
        os.makedirs(directory, exist_ok=True)
        contigs = make_genome()
        write_fasta(paths["ref"], contigs)
        build_index(paths["ref"])
        r1, r2 = simulate_pairs(contigs, n_pairs)
        write_fastq(paths["r1"], r1)
        write_fastq(paths["r2"], r2)
    return paths


def load_reads(path: str, limit: "int | None" = None):
    from mpibwa_tpu_torch.io.fastq import read_fastq

    return read_fastq(path, limit=limit)


# -- edge cases of the extension DP and of the occ4 extension -----------------

EXT_PEN = (6, 1, 6, 1)  # bwa-mem's default o_del, e_del, o_ins, e_ins


def scmat(a: int, b: int) -> np.ndarray:
    """bwa_fill_scmat(a, b): a on the diagonal, -b off it, -1 for N."""
    m = np.full((5, 5), -1, np.int32)
    m[:4, :4] = -b
    m[np.arange(4), np.arange(4)] = a
    return m


def _ext_batch(rows, Q: int, T: int) -> "tuple[np.ndarray, ...]":
    """rows of (query codes, target codes, w, end_bonus, zdrop, h0) ->
    (q (B, Q), t (B, T) uint8 padded with 4, qlens, tlens, params)."""
    B = len(rows)
    q = np.full((B, Q), 4, np.uint8)
    t = np.full((B, T), 4, np.uint8)
    for b, (qs, ts, *_) in enumerate(rows):
        q[b, : len(qs)] = qs
        t[b, : len(ts)] = ts
    ql = np.array([len(r[0]) for r in rows], np.int32)
    tl = np.array([len(r[1]) for r in rows], np.int32)
    par = np.array([r[2:] for r in rows], np.int32).reshape(B, 4)
    return q, t, ql, tl, par


def extend_edge_cases(seed: int) -> "list[dict]":
    """Batches of extension problems that corner a row-parallel DP: each a
    dict of name, q, t, qlens, tlens, params (the inputs of
    ops.extend_batch.extend_batch), mat (5, 5) int32 and pen. All inputs
    come from numpy's generator at ``seed``."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    def similar(q, n, rate=0.03):
        """n target bases that follow q, with substitutions (some N)."""
        t = np.concatenate([q, rand(max(n - len(q), 0))])[:n].copy()
        hit = rng.random(n) < rate
        t[hit] = rng.integers(0, 5, int(hit.sum()))
        return t

    std = scmat(1, 4)
    cases = []

    def add(name, rows, Q, T, mat=std, pen=EXT_PEN):
        q, t, ql, tl, par = _ext_batch(rows, Q, T)
        cases.append({"name": name, "q": q, "t": t, "qlens": ql,
                      "tlens": tl, "params": par,
                      "mat": np.asarray(mat, np.int32), "pen": pen})

    # a=3, b=4: query C A A ..., target A A ...: the row maximum of row i is
    # reached at columns i and i+1 alike (the match after a one-base
    # insertion scores as the mismatch on the diagonal), so every row ties
    # across the columns j, j+1 and, row after row, across every lane
    # boundary (31/32 and 63/64 among them); the highest column wins
    tie = []
    for qlen in (31, 32, 33, 63, 64, 65, 96, 100, 128):
        qs = np.zeros(qlen, np.uint8)
        qs[0] = 1
        tie.append((qs, np.zeros(qlen + 20, np.uint8), 200, 5, 100, 30))
    # the same tie starting deeper in the row, after a matching prefix
    for pre in (27, 58):
        x = rand(pre)
        qs = np.concatenate([x, [1], np.zeros(60, np.uint8)])
        ts = np.concatenate([x, np.zeros(80, np.uint8)])
        tie.append((qs, ts, 200, 0, 0, 20))
    add("row_max_ties_across_lanes", tie, 128, 256, scmat(3, 4))
    # a run of N in the target: the band's right end falls back and then
    # grows again, two columns a row, over slots written rows before
    stale = []
    for _ in range(8):
        qs = rand(int(rng.integers(60, 128)))
        start, nb = int(rng.integers(5, 40)), int(rng.integers(5, 40))
        ts = np.concatenate([qs[:start], np.full(nb, 4, np.uint8),
                             qs[start:]])[:250]
        stale.append((qs, ts, 100, 5, 0, int(rng.integers(10, 90))))
    add("end_regrows_over_old_slots", stale, 128, 256)
    # z-drop on the first row: the first target base mismatches
    zd = []
    for zdrop in (1, 3, 3, 10):
        qs = rand(50)
        ts = similar(qs, 60, 0.0)
        ts[0] = (qs[0] + 1) % 4
        zd.append((qs, ts, 100, 5, zdrop, 40))
    add("zdrop_on_first_row", zd, 64, 128)
    # every cell of the first row is 0 (h0 no more than a mismatch): the
    # row maximum is 0 and the DP stops
    zero = []
    for h0 in (1, 2, 3, 4):
        qs = rand(40)
        ts = similar(qs, 50, 0.0)
        ts[0] = (qs[0] + 2) % 4
        zero.append((qs, ts, 100, 5, 100, h0))
    add("row_max_zero_break", zero, 64, 128)
    # h0 <= o_ins + e_ins: the first-row fill chain is 0 past slot 0
    small = [(qs, similar(qs, 70), 100, 5, 100, h0)
             for h0, qs in ((h, rand(60)) for h in (1, 2, 5, 6, 7, 8))]
    add("h0_at_most_oe_ins", small, 64, 128)
    # qlen in {0, 1, 31, 32, 33, 128, 512} x tlen in {0, 1, 1024}
    grid = []
    for qlen in (0, 1, 31, 32, 33, 128, 512):
        for tlen in (0, 1, 1024):
            qs = rand(qlen)
            grid.append((qs, similar(qs, tlen), 100, 5, 100,
                         int(rng.integers(1, 60))))
    add("qlen_tlen_extremes", grid, 512, 1024)
    # a band of w = 1 and one no narrower than the query
    band = []
    for w in (1, 1, 150, 1000):
        for qlen in (20, 101):
            qs = rand(qlen)
            band.append((qs, similar(qs, qlen + 30, 0.05), w, 5, 100, 25))
    add("band_w1_and_w_at_least_qlen", band, 128, 256)
    # end bonus and gscore at qlen: the whole query aligns (or nearly)
    ends = []
    for eb in (0, 5):
        for qlen, mis in ((40, None), (70, 67), (101, 5), (101, None)):
            qs = rand(qlen)
            ts = similar(qs, qlen + 12, 0.0)
            if mis is not None:
                ts[mis] = (qs[mis] + 1) % 4
            ends.append((qs, ts, 100, eb, 100, 15))
    add("end_bonus_and_gscore_at_qlen", ends, 128, 256)
    # an asymmetric matrix and other penalties (any 5x5 matrix goes
    # through the kernel)
    mat = rng.integers(-5, 4, (5, 5)).astype(np.int32)
    mat[np.arange(4), np.arange(4)] = rng.integers(1, 4, 4)
    odd = []
    for _ in range(12):
        qs = rand(int(rng.integers(1, 128)))
        odd.append((qs, similar(qs, int(rng.integers(1, 256)), 0.08),
                    int(rng.integers(1, 120)), int(rng.choice([0, 5])),
                    int(rng.choice([0, 100])), int(rng.integers(1, 80))))
    add("nonstandard_matrix", odd, 128, 256, mat, (5, 2, 4, 1))
    # the caller's pad problems (qlen 1, h0 1, tlen 0, zero params) and
    # empty ones
    one = np.zeros(1, np.uint8)
    pads = [(one, np.zeros(0, np.uint8), 0, 0, 0, 1)] * 4 + [
        (np.zeros(0, np.uint8), rand(5), 100, 5, 100, 10),
        (rand(5), np.zeros(0, np.uint8), 100, 5, 100, 10),
        (one, rand(3), 0, 0, 0, 1)]
    add("pads_and_empty", pads, 64, 128)
    return cases


EXT_CASES = [c["name"] for c in extend_edge_cases(0)]

OCC4_CASES = ("one_block", "adjacent_blocks", "size_0", "k_0",
              "around_primary", "last_position")


def occ4_edge_intervals(fm, seed: int) -> "dict[str, np.ndarray]":
    """(n, 3) int32 bi-intervals [x0, x1, x2] over fm (anything with
    ``primary`` and ``seq_len``) that corner the block reads of the occ4
    extension, by name (OCC4_CASES): both ends k-1 and k-1+x2 in one
    128-bp block, in adjacent blocks, x2 = 0, x[k] = 0 (the sentinel end),
    intervals that span or end on ``primary``, and the last position.
    Both columns x0 and x1 carry each pattern, so either direction sees
    it."""
    rng = np.random.default_rng(seed)
    n_pos = fm.seq_len + 1  # BWT positions 0..seq_len

    def pair(k, s):
        k = np.asarray(k, np.int64)
        s = np.asarray(s, np.int64)
        other = rng.integers(0, n_pos, len(k))
        return np.concatenate([np.stack([k, other, s], 1),
                               np.stack([other, k, s], 1)])

    def at(p0, p1):
        """(k, s) whose ends k-1 and k-1+s count in the stored bases at
        offsets p0 <= p1 (BWT positions past primary are one higher)."""
        pos0 = p0 + (p0 >= fm.primary)
        return pos0 + 1, p1 + (p1 >= fm.primary) - pos0

    out = {}
    base = rng.integers(0, max((n_pos - 1) // 128 - 1, 1), 64) * 128
    w0 = rng.integers(0, 100, 64)
    out["one_block"] = pair(*at(base + w0, base + w0 + rng.integers(
        1, 128 - w0)))
    out["adjacent_blocks"] = pair(*at(base + 127 - rng.integers(0, 8, 64),
                                      base + 128 + rng.integers(0, 90, 64)))
    out["size_0"] = pair(rng.integers(0, n_pos, 64), np.zeros(64))
    out["k_0"] = pair(np.zeros(16), rng.integers(0, 300, 16))
    p = fm.primary
    ks = np.concatenate([p - np.arange(0, 6), p + np.arange(1, 6),
                         p - 130 + np.arange(3)])
    ss = np.concatenate([np.full(6, 7), np.full(5, 1), np.full(3, 140)])
    ks = np.concatenate([ks, p - 3 + np.arange(4), [p, p + 1]])
    ss = np.concatenate([ss, 4 - np.arange(4), [0, 1]])  # end on primary
    keep = (ks >= 0) & (ks + ss <= n_pos)
    out["around_primary"] = pair(ks[keep], ss[keep])
    out["last_position"] = pair([n_pos - 1, n_pos - 1, n_pos - 2, n_pos - 3],
                                [1, 0, 2, 3])
    return {k: v.astype(np.int32) for k, v in out.items()}


# -- edge lanes of the backward pass ------------------------------------------

def ref_reads(fm, rng, n: int, length: int,
              sub_rate: float = 0.01) -> np.ndarray:
    """(n, length) uint8 base codes read off fm's doubled reference (either
    strand, through ``fm.ref_base``) at positions from rng, with
    substitutions at sub_rate."""
    import torch

    pos = rng.integers(0, 2 * fm.l_pac - length, n)
    idx = torch.from_numpy(pos[:, None] + np.arange(length)).to(fm.device)
    q = fm.ref_base(idx.reshape(-1)).cpu().numpy().astype(np.uint8)
    q = q.reshape(n, length)
    hit = rng.random(q.shape) < sub_rate
    q[hit] = (q[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return q


def forward_lanes(fm, q: np.ndarray, starts=None) -> "list[dict]":
    """The backward lanes of a forward run of the port over reads q (B, L)
    uint8 (4 pads): one per call, each a dict of q (the read's row), x0
    (the call's start), minv 1 and its entries longest match first, ik
    (n, 3) int32, info (n,) int64 and live (n,) bool (all true). Chained
    calls from 0 as in pass 1, or one call from each of starts (B,). Reads
    whose forward buffers overflow are left out."""
    import torch

    from mpibwa_tpu_torch.ops import seeding as TS

    B, L = q.shape
    lens = (q < 4).sum(axis=1).astype(np.int32)
    fwd = TS.forward_pass(
        fm, torch.from_numpy(q).to(fm.device),
        torch.from_numpy(lens).to(fm.device),
        torch.ones(B, dtype=torch.int64, device=fm.device),
        chain=starts is None,
        starts=None if starts is None else torch.from_numpy(
            np.asarray(starts, np.int32)).to(fm.device))
    ivals = fwd.ivals.cpu().numpy()
    infos = fwd.infos.cpu().numpy()
    cx, cs, cl, nc, ov = (t.cpu().numpy() for t in (
        fwd.call_x, fwd.call_start, fwd.call_len, fwd.n_calls,
        fwd.overflow))
    out = []
    for b in range(B):
        if ov[b]:
            continue
        for c in range(int(nc[b])):
            idx = cs[b, c] + cl[b, c] - 1 - np.arange(cl[b, c])
            out.append({"q": q[b], "x0": int(cx[b, c]), "minv": 1,
                        "ik": ivals[b, idx].astype(np.int32),
                        "info": infos[b, idx].astype(np.int64),
                        "live": np.ones(len(idx), bool)})
    return out


BWD_LONG_READ = 320  # bp of the read behind the longest edge lanes


def bwd_edge_lanes(fm, seed: int) -> "list[dict]":
    """Lanes of a backward pass that corner a warp-per-lane kernel, each a
    dict like forward_lanes' with a ``name``: real lanes of reads off fm's
    reference; zero-length and one-entry lanes; lanes of exactly 32, 33,
    64, 65 and 160 entries; lanes of 300 entries (longer than 8 slots of
    32) from a read of BWD_LONG_READ bp that matches the reference, whose
    calls start deep in the read so that their entries live for hundreds
    of rounds, one with its first 40 entries dead; a lane whose entries
    all start dead; a query with N at the next position; lanes that start
    at i = 0 and i = -1; min_intv > 1; dedup chains of equal sizes across
    the slot boundary; intervals that span ``primary``; and random live
    masks. Longer lanes repeat a real lane's entries (each copy behaves as
    the lane itself). Everything derives from numpy's generator at
    ``seed``."""
    rng = np.random.default_rng(seed)
    real = forward_lanes(fm, ref_reads(fm, rng, 12, READ_LEN))
    real.sort(key=lambda ln: -len(ln["ik"]))
    long_q = np.repeat(ref_reads(fm, rng, 1, BWD_LONG_READ, sub_rate=0.0),
                       3, axis=0)
    long_real = forward_lanes(fm, long_q, starts=[60, 150, 280])
    base, lbase = real[0], long_real[-1]
    out = []

    def add(name, lane, **kw):
        out.append(dict(lane, name=name, **kw))

    def take(lane, idx, **kw):
        idx = np.asarray(idx, np.int64)
        d = {k: lane[k][idx] for k in ("ik", "info", "live")}
        return dict(lane, **d, **kw)

    def tiled(lane, m):
        return take(lane, np.arange(m) % len(lane["ik"]))

    add("zero_length", take(base, []))
    for j, ln in enumerate(real[:8]):
        add(f"real_{j}", ln)
    add("one_entry", take(base, [0]))
    add("zero_length", take(base, []), x0=3)
    for m in (32, 33, 64, 65, 160):
        add(f"len_{m}", tiled(base, m))
    for ln in long_real:
        add(f"real_{BWD_LONG_READ}bp_from_{ln['x0']}", ln)
    add(f"len_300_{BWD_LONG_READ}bp", tiled(lbase, 300))
    head_dead = tiled(lbase, 300)
    head_dead["live"] = head_dead["live"].copy()
    head_dead["live"][:40] = False
    add(f"len_300_{BWD_LONG_READ}bp_head_dead", head_dead)
    add("all_dead", base, live=np.zeros(len(base["ik"]), bool))
    qn = base["q"].copy()
    qn[base["x0"] - 1] = 4
    add("n_at_next_position", base, q=qn)
    add("starts_at_i_0", base, x0=1)
    add("starts_at_i_minus_1", base, x0=0)
    for mv in (2, 3, 5):
        add(f"min_intv_{mv}", real[1 + mv % 3], minv=mv)
    # each entry three times over: a keeper's copies have its size, and the
    # chain of entry 10 (entries 30-32) crosses the slot boundary
    add("dedup_chains", take(base, np.repeat(np.arange(len(base["ik"])),
                                             3)))
    prim = occ4_edge_intervals(fm, int(rng.integers(1 << 30)))
    prim = prim["around_primary"]
    n = len(prim)
    add("spans_primary", base, ik=prim,
        info=np.resize(base["info"], n), live=np.ones(n, bool))
    rl = tiled(base, 70)
    rl["live"] = rng.random(70) < 0.7
    add("random_live", rl, minv=2)
    return out


def pack_bwd_lanes(lanes, multiple: int = 1) -> dict:
    """Flat arrays of a backward pass over lanes (as bwd_edge_lanes gives
    them), in the form of the seeder's tables: q (NL, L) uint8, x0 and
    minv (NL,) int32, lane_off (NL + 1,) int32, ik (E, 3) int32, info (E,)
    int64, lane (E,) int32, live (E,) bool, E, NL and names. A pad lane of
    dead entries takes E to a multiple of ``multiple`` where needed."""
    lanes = list(lanes)
    E = sum(len(ln["ik"]) for ln in lanes)
    if E % multiple:
        k = multiple - E % multiple
        src = next(ln for ln in lanes if len(ln["ik"]))
        lanes.append(dict(src, name="pad", minv=1,
                          ik=np.resize(src["ik"], (k, 3)),
                          info=np.resize(src["info"], k),
                          live=np.zeros(k, bool)))
    n = np.array([len(ln["ik"]) for ln in lanes])
    L = max(len(ln["q"]) for ln in lanes)
    q = np.full((len(lanes), L), 4, np.uint8)
    for j, ln in enumerate(lanes):
        q[j, : len(ln["q"])] = ln["q"]
    cat = [np.concatenate([ln[k] for ln in lanes]) for k in
           ("ik", "info", "live")]
    return {"q": q, "x0": np.array([ln["x0"] for ln in lanes], np.int32),
            "minv": np.array([ln["minv"] for ln in lanes], np.int32),
            "lane_off": np.concatenate([[0], np.cumsum(n)]).astype(np.int32),
            "ik": cat[0].reshape(-1, 3).astype(np.int32),
            "info": cat[1].astype(np.int64), "live": cat[2].astype(bool),
            "lane": np.repeat(np.arange(len(lanes)), n).astype(np.int32),
            "E": int(n.sum()), "NL": len(lanes),
            "names": [ln["name"] for ln in lanes]}


def release_memory() -> None:
    """Give a test module's memory back to the system: JAX's compiled
    programs and the C heap's free pages. A test worker outlives its
    modules and sits idle holding both while a large test in another
    worker needs the room."""
    import ctypes
    import gc

    import jax

    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass  # not glibc: the pages stay with the process


@pytest.fixture(scope="module", autouse=True)
def release_memory_fixture():
    """release_memory at the end of each test module that imports this."""
    yield
    release_memory()
