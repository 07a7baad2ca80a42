"""The v8 backward-SMEM engine of mpibwa_tpu/ops/backward8.py on torch
tensors, with its O2 rank helpers.

The O2 table holds one (2,) int32 row [occ_c, packed_word] per (16-base
sub-block, base), so a single-base rank is one row gather with the base
folded into the index.

v8 runs the backward pass of bwt_smem1a (bwt.c:326-345) over the entries
of all lanes in one flat, lane-contiguous state, with no scans in a round.
Three facts about that pass allow it (each lane's intervals are nested
with sizes non-decreasing in slot order, which bwt_extend keeps):

1. Extension failures form a prefix of each lane's live entries and
   keepers a suffix, so an entry is the lane's first live entry exactly
   when it is live and its slot predecessor is dead or in another lane.
2. Dedup (bwt.c:338) changes no output: nested intervals of equal size
   are the same interval, so a duplicate fails with its twin and never
   sits first.
3. Nothing downstream reads x[1] of a mem (mem_chain reads x[0], x[2] and
   info, bwamem.c:277-289), so v8 keeps x[1] at its forward value and
   ranks only the base it extends by.

The JAX layout is (8, W) with slot r*W + c; here the state is flat (E,)
tensors in that slot order, and "the slot before" is a shift by one.

run_backward8 runs segments of SEG_ROUNDS rounds, reads the live count once
a segment and compacts the live entries to a smaller capacity (evacuating
the mems emitted so far into an accumulator, dropping those shorter than
min_len) until the capacity is at most MIN_CAP; then rounds run until no
entry is live, with one host read every TAIL_STEPS rounds. An accumulator
that fills reports overflow, and the caller redoes the work on the exact
flat engine. The JAX package also learns and replays a capacity schedule
to avoid host round trips on a remotely attached TPU; that changes no
output and is not here.

The packed words are uint32 in the index. torch has no general uint32
arithmetic and its ``>>`` on signed integers is arithmetic, so the SWAR
code here holds each word in an int64 in [0, 2**32) and masks with
``& 0xFFFFFFFF`` after every ``~`` and left shift.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpibwa_tpu_torch.ops.pulls import (lane_lists, note_pass, pack_rows,
                                        pull_rows)

SEG_ROUNDS = 4  # rounds a segment between compactions (the first: one more)
MIN_CAP = 8192  # capacity at which the rounds run on to the end
TAIL_STEPS = 4  # rounds between host reads of "any entry live" at the end
ACC_ROWS = 65536  # least rows of the accumulator of evacuated mems
U32 = 0xFFFFFFFF
M55 = 0x55555555
M33 = 0x33333333
M0F = 0x0F0F0F0F


def cap_bucket(n: int, floor: int = MIN_CAP) -> int:
    """Smallest {2^k, 1.5*2^k} ladder capacity >= n (multiple of 8)."""
    c = floor
    while c < n:
        if (c + (c >> 1)) >= n and (c + (c >> 1)) % 8 == 0:
            return c + (c >> 1)
        c <<= 1
    return c


def build_o2(bwt_arr) -> np.ndarray:
    """Derived O2 table (numpy): row[sb*4 + c] = [occ_c(sb),
    packed_word(sb)] for every 16-base sub-block sb and base c."""
    n_blocks = len(bwt_arr) // 16
    blocks = np.ascontiguousarray(bwt_arr[: n_blocks * 16]).reshape(
        n_blocks, 16)
    occ = blocks[:, :8].copy().view(np.uint64).astype(np.int64)  # (nb, 4)
    words = np.ascontiguousarray(blocks[:, 8:])  # (nb, 8) uint32

    def popcnt_pairs(m):
        x = (m & 0x33333333) + ((m >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        return (((x * 0x01010101) >> 24) & 0xFF).astype(np.int64)

    w = words.astype(np.uint32)
    nw = ~w
    wc = np.zeros((n_blocks, 8, 4), np.int64)
    for c in range(4):
        a = (w if c & 2 else nw) >> 1
        b = w if c & 1 else nw
        wc[:, :, c] = popcnt_pairs(a & b & np.uint32(0x55555555))
    wcum = np.zeros((n_blocks, 8, 4), np.int64)
    wcum[:, 1:] = np.cumsum(wc, axis=1)[:, :-1]
    occ16 = occ[:, None, :] + wcum  # (nb, 8, 4) counts at sub-block starts
    if occ16.max() > np.iinfo(np.int32).max:
        raise ValueError("occ counts exceed int32")
    n16 = n_blocks * 8
    o2 = np.zeros((n16 * 4, 2), np.int32)
    o2[:, 0] = occ16.reshape(n16 * 4).astype(np.int32)
    o2[:, 1] = np.repeat(words.reshape(n16).view(np.int32), 4)
    return np.ascontiguousarray(o2)


def _count_prefix(word_i32: torch.Tensor, c: torch.Tensor,
                  within: torch.Tensor) -> torch.Tensor:
    """Occurrences of base c in the first within+1 bases of the MSB-first
    packed word, incl. the bwt.c:183-184 base-0 pad correction. int32."""
    sh = 30 - 2 * within.to(torch.int64)
    keep = ~((torch.ones_like(sh) << sh) - 1) & U32
    w = (word_i32.to(torch.int64) & U32) & keep
    nw = ~w & U32
    a = torch.where((c & 2) != 0, w, nw) >> 1
    b = torch.where((c & 1) != 0, w, nw)
    m = a & b & M55
    x = (m & M33) + ((m >> 2) & M33)
    x = (x + (x >> 4)) & M0F
    cnt = ((x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F).to(torch.int32)
    corr = torch.where(c == 0, 15 - within.to(torch.int32), 0)
    return cnt - corr


def _occ_c2(o2: torch.Tensor, primary: int, ks: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """Rank of base c at positions ks (int32 or int64; negative =
    sentinel) via the O2 table: one row gather per position. int32."""
    sent = ks < 0
    k = torch.where(sent, torch.zeros_like(ks), ks)
    k = k - (k >= primary).to(k.dtype)
    sb = k >> 4
    within = (k & 15).to(torch.int32)
    idx = ((sb << 2) + c).clamp(0, o2.shape[0] - 1)
    row = o2[idx]
    out = row[..., 0] + _count_prefix(row[..., 1], c, within)
    return torch.where(sent, 0, out)


# -- rounds -------------------------------------------------------------------


class V8State(NamedTuple):
    """Per-entry state, flat and lane-contiguous (dead entries: lane NL)."""
    ik0: torch.Tensor  # idt
    ik1: torch.Tensor  # idt, the forward value (fact 3)
    ik2: torch.Tensor  # int32
    live: torch.Tensor  # bool
    i: torch.Tensor  # int32 query position the entry extends to next
    info: torch.Tensor  # int32 end of the match
    lane: torch.Tensor  # int32
    minv: torch.Tensor  # int32 min_intv of the entry's lane
    bound: torch.Tensor  # bool: the first slot of a lane
    emitted: torch.Tensor  # bool: a mem, not yet evacuated
    em_start: torch.Tensor  # int32 start of the mem


def _prev_slot(x: torch.Tensor, fill) -> torch.Tensor:
    """The slot-order predecessor of each entry (fill before slot 0)."""
    return torch.cat([x.new_full((1,), fill), x[:-1]])


def _round8(o2, l2sel, primary: int, qflat, L: int, st: V8State
            ) -> V8State:
    """One backward round over every entry: both ranks in one O2 gather,
    the first live entry of a lane by its neighbour (fact 1)."""
    E = st.ik0.shape[0]
    valid = (st.i >= 0) & (st.i < L)
    qoff = (st.lane.to(torch.int64) * L + st.i.clamp(0, L - 1)).clamp(
        max=qflat.shape[0] - 1)
    qi = torch.where(valid, qflat[qoff], 4)
    c = qi.clamp(max=3)
    has_c = valid & (qi < 4)
    kq = st.ik0 - 1
    t2 = _occ_c2(o2, primary, torch.cat([kq, kq + st.ik2]),
                 torch.cat([c, c]))
    tk, tl = t2[:E], t2[E:]
    s2 = tl - tk
    k2 = l2sel[c.long()] + 1 + tk
    keeper = st.live & has_c & (s2 >= st.minv)
    # the first live entry emits when it fails (bwt.c:329-337); the C
    # loop's containment check never fires here (start i + 1 only falls)
    is_first = st.live & (st.bound | ~_prev_slot(st.live, False))
    emit = is_first & ~keeper
    return st._replace(ik0=torch.where(keeper, k2, st.ik0),
                       ik2=torch.where(keeper, s2, st.ik2), live=keeper,
                       i=torch.where(keeper, st.i - 1, st.i),
                       emitted=st.emitted | emit,
                       em_start=torch.where(emit, st.i + 1, st.em_start))


def segment8(fm, qflat, st: V8State, L: int, n_rounds: int) -> V8State:
    """n_rounds rounds at the current capacity, no host read."""
    o2, l2sel = fm.o2_tables(), fm.L2[:4]
    for _ in range(n_rounds):
        st = _round8(o2, l2sel, fm.primary, qflat, L, st)
    return st


def tail8(fm, qflat, st: V8State, L: int) -> "tuple[V8State, int]":
    """Rounds until no entry is live, at most about L + 2 (a round over
    dead entries changes nothing, so TAIL_STEPS rounds run between host
    reads). Returns the state and the host reads made."""
    o2, l2sel = fm.o2_tables(), fm.L2[:4]
    r = reads = 0
    while r < L + 2:
        reads += 1
        if not bool(st.live.any()):
            break
        for _ in range(TAIL_STEPS):
            st = _round8(o2, l2sel, fm.primary, qflat, L, st)
        r += TAIL_STEPS
    return st, reads


def _emitted_rows(st: V8State, idt) -> torch.Tensor:
    """(E, 6) rows [x0, x1, x2, start, end, lane] of every entry."""
    return torch.stack([st.ik0, st.ik1, st.ik2.to(idt), st.em_start.to(idt),
                        st.info.to(idt), st.lane.to(idt)], dim=1)


def _compact(rows: torch.Tensor, keep: torch.Tensor, cap: int
             ) -> torch.Tensor:
    """rows where keep, in order, at the front of a (cap + 1, 6) buffer
    whose last row takes whatever does not fit (dropped)."""
    pos = torch.cumsum(keep, 0, dtype=torch.int64) - 1
    out = rows.new_zeros((cap + 1, rows.shape[1]))
    out[torch.where(keep, pos, cap).clamp(max=cap)] = rows
    return out


def shrink8(st: V8State, acc: torch.Tensor, acc_off: torch.Tensor,
            newE: int, NL: int, min_len: int):
    """Compaction to capacity newE: live entries move to the front, in
    order (lanes stay contiguous); emitted entries at least min_len long
    are evacuated into the accumulator acc ((MAXM + 1, 6), last row a
    dump) at acc_off, the rest dropped. Returns (state, acc, acc_off,
    overflow: the live entries or the mems did not fit), all on the
    device."""
    maxm = acc.shape[0] - 1
    pos_live = torch.cumsum(st.live, 0, dtype=torch.int64) - 1
    n_live = st.live.sum()
    dest_live = torch.where(st.live, pos_live, newE).clamp(max=newE)
    em = st.emitted & ((st.info - st.em_start) >= min_len)
    pos_em = torch.cumsum(em, 0, dtype=torch.int64) - 1 + acc_off
    acc[torch.where(em, pos_em, maxm).clamp(max=maxm)] = _emitted_rows(
        st, acc.dtype)
    acc_off = acc_off + em.sum()
    overflow = (n_live > newE) | (acc_off > maxm)

    def put(x, fill=0):
        out = x.new_full((newE + 1,), fill)
        out[dest_live] = x
        return out[:newE]

    lane = put(st.lane, NL)
    zeros = torch.zeros(newE, dtype=torch.int32, device=lane.device)
    st2 = V8State(put(st.ik0), put(st.ik1), put(st.ik2), put(st.live, False),
                  put(st.i), put(st.info), lane, put(st.minv),
                  lane != _prev_slot(lane, -1), zeros.bool(), zeros)
    return st2, acc, acc_off, overflow


def pack_emitted8(st: V8State, idt) -> "tuple[torch.Tensor, torch.Tensor]":
    """The tail's emitted rows compacted to the front of an (E, 6)
    buffer, and their count."""
    E = st.ik0.shape[0]
    return (_compact(_emitted_rows(st, idt), st.emitted, E)[:E],
            st.emitted.sum())


def _merge_filter(acc, acc_off, tail, n_tail, min_len: int, overflow
                  ) -> torch.Tensor:
    """Accumulator rows, then the tail's, those at least min_len long, in
    order (so chronological within a lane), behind a header row [count,
    overflow, 0, 0, 0, 0]: a (1 + N + 1, 6) buffer, the last row a dump."""
    maxm = acc.shape[0] - 1
    allr = torch.cat([acc[:maxm], tail])
    N = allr.shape[0]
    idx = torch.arange(N, device=allr.device)
    valid = (idx < acc_off) | ((idx >= maxm) & (idx < maxm + n_tail))
    keep = valid & ((allr[:, 4] - allr[:, 3]) >= min_len)
    return pack_rows(allr, keep, overflow)


def _acc_rows(E: int, min_len: int) -> int:
    """Rows of the accumulator of a pass of E entries. With min_len 0
    every emission is kept: room for all of them; a filter at 19 bases
    keeps about 1% of them on 101-bp reads."""
    return max(ACC_ROWS, E) if min_len <= 0 else max(ACC_ROWS, E // 8)


def run_backward8(fm, qrows_dev, entry_dev, n_lanes: int, x0, minv,
                  min_len: int = 0, raw: bool = False, est_rows: int = 0,
                  extra_ov=None, stats: "dict | None" = None):
    """v8 over the entries of entry_dev, with the contract of
    seeding_flat.run_backward_flat, except that x[1] of a mem is its
    forward value (fact 3) and mems shorter than min_len are dropped on
    the device.

    qrows_dev: (NL, L) uint8 read rows; entry_dev: (ik (E, 3) idt, info,
    lane, live) from seeding_flat.assemble_entries; x0, minv: (NL,) numpy
    or device tensors. extra_ov: a device bool the caller raises (a
    capacity its tables outgrew), reported as an overflow. stats, when
    given, accumulates "bwd_segments" (host reads).

    Returns (per-lane mem lists [(x0, x1, x2, info)], overflow (NL,)
    bool: all true when anything overflowed), or with raw=True ((n, 6)
    rows [x0, x1, x2, start, end, lane] in the index dtype, chronological
    within a lane, overflow bool). The rows come back in one pull of a
    header row and the first est_rows rows; only more rows than that cost
    a second pull."""
    NL, L = int(qrows_dev.shape[0]), int(qrows_dev.shape[1])
    ik, info, lane, live = entry_dev
    E = int(ik.shape[0])
    dev = ik.device
    idt = fm.idt

    def on_dev(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.int32)
        return torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)

    qflat = qrows_dev.reshape(-1).to(torch.int32)
    lane_c = lane.long().clamp(0, NL - 1)
    lane_m = torch.where(live, lane.to(torch.int32), NL)
    st = V8State(ik[:, 0].to(idt), ik[:, 1].to(idt), ik[:, 2].to(torch.int32),
                 live.clone(), on_dev(x0)[lane_c] - 1, info.to(torch.int32),
                 lane_m, on_dev(minv)[lane_c],
                 lane_m != _prev_slot(lane_m, -1),
                 torch.zeros(E, dtype=torch.bool, device=dev),
                 torch.zeros(E, dtype=torch.int32, device=dev))
    maxm = _acc_rows(E, min_len)
    acc = torch.zeros((maxm + 1, 6), dtype=idt, device=dev)
    acc_off = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    reads = seg = 0
    cap = E
    max_segs = (L + 2) // SEG_ROUNDS + 2
    while cap > MIN_CAP and seg < max_segs:
        st = segment8(fm, qflat, st, L,
                      SEG_ROUNDS + 1 if seg == 0 else SEG_ROUNDS)
        n_live = int(st.live.sum())  # one host read a segment
        reads += 1
        if n_live == 0:
            break
        newE = min(cap_bucket(n_live, MIN_CAP), cap)
        if newE < cap:
            st, acc, acc_off, ov = shrink8(st, acc, acc_off, newE, NL,
                                           min_len)
            overflow = overflow | ov
            cap = newE
        seg += 1
    st, tail_reads = tail8(fm, qflat, st, L)
    tail, n_tail = pack_emitted8(st, idt)
    if extra_ov is not None:
        overflow = overflow | extra_ov
    comb = _merge_filter(acc, acc_off, tail, n_tail, min_len, overflow)
    rows, ov, pulls = pull_rows(comb, est_rows)
    note_pass(stats, reads + tail_reads + pulls)
    return (rows, ov) if raw else lane_lists(rows, ov, n_lanes)
