"""Flat-queue backward SMEM pass (bwt.c:326-345), PyTorch.

Counterpart of mpibwa_tpu/ops/seeding_flat.py, the exact "flat" engine:
the surviving intervals of all (read, call) lanes live in one flat array
sorted by lane; every round extends the live entries and applies the
per-lane keep/dedup/emit logic with segmented scans written as cumsum /
cummax over the flat array. The driver compacts live entries to a smaller
capacity while the capacity is large, then runs the remaining rounds at a
small capacity until no entry is live ("hybrid" schedule). The same
module holds the JAX package's opt-in contig engine (MPIBWA_BWD=contig,
run_backward_contig), which keeps each lane's live entries contiguous.

Scatters that JAX drops out of range go to one extra dump row or column
here, which is sliced off.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

M_CAP = 16  # max mems per lane (overflow -> scalar fallback)
SEG_SCHEDULE = (1, 2, 4)  # rounds per segment: most entries die fast
FINISH_CAP = 4096  # below this capacity, run to the end without compacting


class FlatState(NamedTuple):
    ik: torch.Tensor  # (E, 3) idt
    info: torch.Tensor  # (E,) int64
    lane: torch.Tensor  # (E,) int64, ascending
    live: torch.Tensor  # (E,) bool
    i: torch.Tensor  # (NL,) int32
    active: torch.Tensor  # (NL,) bool
    last_start: torch.Tensor  # (NL + 1,) int64, last = dump
    minv: torch.Tensor  # (NL,) idt
    mems: torch.Tensor  # (NL + 1, M_CAP, 3), last row = dump
    mem_infos: torch.Tensor  # (NL + 1, M_CAP) int64, last row = dump
    n_mems: torch.Tensor  # (NL,) int32
    overflow: torch.Tensor  # (NL,) bool


def _segment_start(lane_start: torch.Tensor) -> torch.Tensor:
    """Index of the first position of each position's segment."""
    pos = torch.arange(lane_start.shape[0], device=lane_start.device)
    return torch.cummax(torch.where(lane_start, pos, 0), dim=0).values


def _seg_excl_cumsum(x: torch.Tensor, seg0: torch.Tensor) -> torch.Tensor:
    """Segmented exclusive cumsum of int x; seg0 = _segment_start."""
    c = torch.cumsum(x, dim=0)
    return c - x - (c[seg0] - x[seg0])


def _seg_prev_keeper(keeper: torch.Tensor, seg0: torch.Tensor):
    """For each position: whether a keeper precedes it in its segment, and
    the index of the last such keeper (meaningful only where it exists)."""
    pos = torch.arange(keeper.shape[0], device=keeper.device)
    last = torch.cummax(torch.where(keeper, pos, -1), dim=0).values
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    return prev >= seg0, prev.clamp(min=0)


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, seg, x)


def _round(fm, st: FlatState, qrows: torch.Tensor, seg0) -> FlatState:
    """One backward round over every live entry."""
    NL, L = qrows.shape
    lane = st.lane
    i_lane = st.i[lane]
    live = st.live & st.active[lane]
    qi = torch.where((i_lane >= 0) & (i_lane < L),
                     qrows[lane, i_lane.clamp(0, L - 1).long()].to(torch.int32),
                     4)
    has_c = (i_lane >= 0) & (qi < 4)
    c = qi.clamp(0, 3).long()
    ok = fm.extend(st.ik, 1)  # (E, 4, 3)
    okc = ok[torch.arange(ok.shape[0], device=ok.device), c]
    keeper = live & has_c & (okc[:, 2] >= st.minv[lane])

    # mem emission: the first live (longest-match) entry fails extension
    first_live = live & (_seg_excl_cumsum(live.to(torch.int32), seg0) == 0)
    not_contained = (i_lane + 1).to(torch.int64) < st.last_start[lane]
    emit = first_live & ~keeper & not_contained
    # the mem buffers and last_start are updated in place (the previous
    # round's state is never read again); non-emitting entries write the
    # dump row NL
    midx = st.n_mems[lane].clamp(max=M_CAP - 1).long()
    lane_sel = torch.where(emit, lane, NL)
    st.mems[lane_sel, midx] = st.ik
    st.mem_infos[lane_sel, midx] = (st.info
                                    | ((i_lane + 1).to(torch.int64) << 32))
    st.last_start[lane_sel] = (i_lane + 1).to(torch.int64)
    n_mems = st.n_mems + _segment_sum(emit.to(torch.int32), lane, NL)
    ov_e = (emit & (st.n_mems[lane] >= M_CAP)).to(torch.int32)
    overflow = st.overflow | (_segment_sum(ov_e, lane, NL) > 0)

    # dedup: drop a keeper whose previous keeper in the lane has the same
    # interval size (bwt.c:338)
    has_prev, prev = _seg_prev_keeper(keeper, seg0)
    append = keeper & (~has_prev | (okc[:, 2] != okc[prev, 2]))
    n_new = _segment_sum(append.to(torch.int32), lane, NL)
    cont = st.active & (n_new > 0)
    return FlatState(torch.where(append[:, None], okc, st.ik), st.info, lane,
                     append, torch.where(cont, st.i - 1, st.i), cont,
                     st.last_start, st.minv, st.mems, st.mem_infos, n_mems,
                     overflow)


def _lane_starts(lane: torch.Tensor) -> torch.Tensor:
    return torch.cat([lane.new_ones(1, dtype=torch.bool), lane[1:] != lane[:-1]])


def flat_rounds(fm, st: FlatState, qrows: torch.Tensor,
                n_rounds: int) -> FlatState:
    """n_rounds backward rounds at the current capacity."""
    seg0 = _segment_start(_lane_starts(st.lane))
    for _ in range(n_rounds):
        st = _round(fm, st, qrows, seg0)
    return st


def flat_rounds_while(fm, st: FlatState, qrows: torch.Tensor,
                      max_rounds: int) -> FlatState:
    """Rounds until no entry is live (or the max_rounds safety bound)."""
    seg0 = _segment_start(_lane_starts(st.lane))
    r = 0
    while r < max_rounds and bool((st.live & st.active[st.lane]).any()):
        st = _round(fm, st, qrows, seg0)
        r += 1
    return st


def assemble_entries(ivals: torch.Tensor, infos: torch.Tensor,
                     lane_row: torch.Tensor, lane_tbl: torch.Tensor, E: int):
    """Build the flat entry arrays on the device from forward-pass buffers.

    lane_row: (NL,) row into ivals/infos; lane_tbl: (NL, 3) int32 =
    (push_start, push_len, entry_start). Entry j of lane ln maps to push
    index push_start + push_len-1 - (j - entry_start) (reversed push order,
    longest match first). The lane of entry e is the last lane with
    entry_start <= e: a scatter-max of lane ids at their starts (ties of
    zero-length lanes resolve to the last lane; starts >= E drop out),
    then a running max."""
    NL = lane_row.shape[0]
    dev = ivals.device
    starts = lane_tbl[:, 2].long()
    marks = torch.zeros(E + 1, dtype=torch.int64, device=dev)
    marks.scatter_reduce_(0, starts.clamp(0, E),
                          torch.arange(NL, device=dev), "amax")
    lane = torch.cummax(marks[:E], dim=0).values.clamp(0, NL - 1)
    e_idx = torch.arange(E, device=dev)
    j_in = e_idx - starts[lane]
    push = (lane_tbl[lane, 0] + lane_tbl[lane, 1] - 1).long() - j_in
    row = lane_row[lane].long()
    safe = push.clamp(0, ivals.shape[1] - 1)
    ik = ivals[row, safe]
    info = infos[row, safe].to(torch.int64)
    live = (j_in >= 0) & (j_in < lane_tbl[lane, 1])
    return ik, info, lane, live


def compact_entries(ik, info, lane, live, newE: int, pad_lane: int):
    """Stable compaction of live entries to the front of a smaller array."""
    order = torch.sort((~live).to(torch.int8), stable=True).indices[:newE]
    live2 = live[order]
    lane2 = torch.where(live2, lane[order], pad_lane)
    return ik[order], info[order], lane2, live2


def flatten_mems(mems, mem_infos, n_mems, TOT: int):
    """Compact per-lane mem buffers into one flat array of TOT entries so
    the host pulls only real data."""
    NL, M = mems.shape[0], mems.shape[1]
    off = torch.cumsum(n_mems, 0) - n_mems
    j = torch.arange(M, device=mems.device)[None, :]
    dest = torch.where(j < n_mems[:, None], off[:, None] + j, TOT).reshape(-1)
    flat = torch.zeros((TOT + 1, 3), dtype=mems.dtype, device=mems.device)
    flat[dest] = mems.reshape(-1, 3)
    flat_i = torch.zeros(TOT + 1, dtype=mem_infos.dtype,
                         device=mems.device)
    flat_i[dest] = mem_infos.reshape(-1)
    return flat[:TOT], flat_i[:TOT]


def _pad_cap(n: int) -> int:
    c = 256
    while c < n:
        c <<= 2
    return c


def _pull_mems(mems, mem_infos, n_mems, overflow):
    """Final pull: flatten the mems (NL, M_CAP, 3) and their infos (NL,
    M_CAP) on the device, ship only real entries. Returns (per-lane lists
    of (x0, x1, x2, info), overflow (NL,))."""
    NL = mems.shape[0]
    nm = n_mems.clamp(max=M_CAP)
    nm_np = nm.cpu().numpy()
    overflow = overflow.cpu().numpy().copy()
    out_mems = [[] for _ in range(NL)]
    total = int(nm_np.sum())
    if total:
        flat, flat_i = flatten_mems(mems, mem_infos, nm, _pad_cap(total))
        flat_np = flat[:total].cpu().numpy()
        fi_np = flat_i[:total].cpu().numpy()
        off = 0
        for ln in range(NL):
            for j in range(nm_np[ln]):
                out_mems[ln].append(
                    (int(flat_np[off + j, 0]), int(flat_np[off + j, 1]),
                     int(flat_np[off + j, 2]), int(fi_np[off + j])))
            off += nm_np[ln]
    return out_mems, overflow


def run_backward_flat(fm, qrows_dev, entry_dev, n_lanes: int, x0_np,
                      minv_np, stats: "dict | None" = None):
    """Device-resident driver of the backward pass.

    qrows_dev: (NL, L) uint8 read rows; entry_dev: (ik, info, lane, live)
    from assemble_entries; x0_np/minv_np: (NL,) numpy. Per segment one
    live count crosses to the host; mems are pulled once at the end.
    stats, when given, accumulates "bwd_segments" (host round trips).
    Returns (per-lane mem lists, overflow (NL,))."""
    NL = n_lanes
    dev = qrows_dev.device
    ik, info, lane, live = entry_dev
    act = _segment_sum(live.to(torch.int32), lane, NL) > 0
    st = FlatState(
        ik, info, lane, live,
        torch.from_numpy(x0_np.astype(np.int32) - 1).to(dev), act,
        torch.full((NL + 1,), 1 << 62, dtype=torch.int64, device=dev),
        torch.from_numpy(minv_np.astype(fm.np_idt)).to(dev),
        torch.zeros((NL + 1, M_CAP, 3), dtype=ik.dtype, device=dev),
        torch.zeros((NL + 1, M_CAP), dtype=torch.int64, device=dev),
        torch.zeros(NL, dtype=torch.int32, device=dev),
        torch.zeros(NL, dtype=torch.bool, device=dev))
    L = qrows_dev.shape[1]
    seg_i = 0
    while True:
        n_rounds = SEG_SCHEDULE[min(seg_i, len(SEG_SCHEDULE) - 1)]
        seg_i += 1
        st = flat_rounds(fm, st, qrows_dev, n_rounds)
        n_live = int(st.live.sum())  # one scalar crosses to the host
        if n_live == 0:
            break
        newE = _pad_cap(n_live)
        if newE < st.ik.shape[0]:
            st = st._replace(**dict(zip(
                ("ik", "info", "lane", "live"),
                compact_entries(st.ik, st.info, st.lane, st.live, newE,
                                NL - 1))))
        if st.ik.shape[0] <= FINISH_CAP:
            st = flat_rounds_while(fm, st, qrows_dev, L + 1)
            break
    if stats is not None:
        stats["bwd_segments"] = stats.get("bwd_segments", 0) + seg_i
    return _pull_mems(st.mems[:NL], st.mem_infos[:NL], st.n_mems,
                      st.overflow)


# ---------------------------------------------------------------------------
# The contig engine (MPIBWA_BWD=contig, opt-in): the same pass with live
# entries kept contiguous per lane by a full compaction every round. In
# bwt_smem1a's backward loop (bwt.c:326-345) the failures of a round form a
# prefix of each lane's live entries and the keepers a suffix, so each
# segmented scan of the flat engine becomes a comparison with the slot
# before, and the per-lane bookkeeping a searchsorted over the sorted lane
# column. State is column layout: kls (3, E), entries on the minor axis.
# Its ladder of segments runs SEG_SCHEDULE, as the flat engine's does.
# ---------------------------------------------------------------------------

CONTIG_FINISH_CAP = 16384  # at or below this capacity, run to the end
CONTIG_TAIL_STEPS = 4  # rounds between host reads of "any lane active"


class ContigState(NamedTuple):
    kls: torch.Tensor  # (3, E) idt: k, l, s rows
    info: torch.Tensor  # (E,) int32 (forward 'end' payload)
    lane: torch.Tensor  # (E,) int32 ascending; NL = dead sentinel
    i: torch.Tensor  # (NL,) int32 current backward position
    active: torch.Tensor  # (NL,) bool
    last_start: torch.Tensor  # (NL,) int32
    minv: torch.Tensor  # (NL,) idt
    mems_kls: torch.Tensor  # (3, NL*M_CAP + 1) idt, last column = dump
    mems_inf: torch.Tensor  # (2, NL*M_CAP + 1) int32: info_lo, start
    n_mems: torch.Tensor  # (NL,) int32
    overflow: torch.Tensor  # (NL,) bool


def assemble_cols(ivals: torch.Tensor, infos: torch.Tensor,
                  lane_row: torch.Tensor, lane_tbl: torch.Tensor, E: int):
    """assemble_entries in column layout: (kls (3, E), info (E,) int32,
    lane (E,) int32) with live entries contiguous per lane and the dead
    tail's lane == NL."""
    NL = lane_row.shape[0]
    ik, info, lane, live = assemble_entries(ivals, infos, lane_row,
                                            lane_tbl, E)
    lane = torch.where(live, lane, NL).to(torch.int32)
    return ik.t().contiguous(), info.to(torch.int32), lane


def _shift1(x: torch.Tensor, first) -> torch.Tensor:
    """x moved one slot later, with ``first`` in slot 0."""
    return torch.cat([x.new_full((1,), first), x[:-1]])


def _round_contig(fm, st: ContigState, qrows: torch.Tensor,
                  NL: int) -> ContigState:
    """One backward round over every live entry; the mem buffers are
    updated in place (the previous state is never read again)."""
    E = st.lane.shape[0]
    L = qrows.shape[1]
    M = M_CAP
    dev = st.lane.device
    lane = st.lane
    lane_c = lane.clamp(max=NL - 1)
    valid = lane < NL
    i_lane = st.i[lane_c]  # (E,)
    qi = torch.where((i_lane >= 0) & (i_lane < L),
                     qrows[lane_c, i_lane.clamp(0, L - 1)].to(torch.int32), 4)
    has_c = (i_lane >= 0) & (qi < 4)
    c = qi.clamp(0, 3)

    k2, l2, s2 = fm.extend_back1(st.kls[0], st.kls[1], st.kls[2], c)
    keeper = valid & has_c & (s2 >= st.minv[lane_c])

    # neighbour logic (failures are a prefix, keepers a suffix per lane)
    boundary = lane != _shift1(lane, -1)
    append = keeper & (boundary | ~_shift1(keeper, False)
                       | (s2 != _shift1(s2, 0)))

    # per-lane bookkeeping: first and last live entry by searchsorted
    lanes_r = torch.arange(NL, dtype=torch.int32, device=dev)
    pos_f = torch.searchsorted(lane, lanes_r, side="left")
    pos_l = torch.searchsorted(lane, lanes_r, side="right") - 1
    posf_c = pos_f.clamp(0, E - 1)
    lane_has = (pos_l >= pos_f) & (lane[posf_c] == lanes_r)

    # emission: the first live entry failed (bwt.c:329-334), not contained
    emit_l = lane_has & ~keeper[posf_c] & ((st.i + 1) < st.last_start)
    midx = st.n_mems.clamp(max=M - 1)
    dest_m = torch.where(emit_l, lanes_r * M + midx, NL * M).long()
    st.mems_kls[:, dest_m] = st.kls[:, posf_c]
    st.mems_inf[:, dest_m] = torch.stack([st.info[posf_c], st.i + 1])
    overflow = st.overflow | (emit_l & (st.n_mems >= M))
    n_mems = st.n_mems + emit_l.to(torch.int32)
    last_start = torch.where(emit_l, st.i + 1, st.last_start)

    # a lane goes on iff its last live entry kept (keepers are a suffix)
    new_active = lane_has & keeper[pos_l.clamp(0, E - 1)]
    new_i = torch.where(new_active, st.i - 1, st.i)

    # full compaction: appended entries to the front, order kept
    incl = torch.cumsum(append.to(torch.int32), 0)
    dest = torch.where(append, incl - 1, E).long()
    new_kls = st.kls.new_zeros((3, E + 1))
    new_kls[:, dest] = torch.stack([k2, l2, s2])
    new_info = st.info.new_zeros(E + 1)
    new_info[dest] = st.info
    new_lane = lane.new_full((E + 1,), NL)
    new_lane[dest] = lane
    return ContigState(new_kls[:, :E], new_info[:E], new_lane[:E], new_i,
                       new_active, last_start, st.minv, st.mems_kls,
                       st.mems_inf, n_mems, overflow)


def contig_rounds(fm, st: ContigState, qrows: torch.Tensor, n_rounds: int,
                  NL: int) -> ContigState:
    for _ in range(n_rounds):
        st = _round_contig(fm, st, qrows, NL)
    return st


def contig_rounds_while(fm, st: ContigState, qrows: torch.Tensor,
                        max_rounds: int, NL: int) -> ContigState:
    """Rounds until no lane is active (at most max_rounds), one host read
    every CONTIG_TAIL_STEPS rounds: a round after the last lane stopped
    changes nothing."""
    r = 0
    while r < max_rounds and bool(st.active.any()):
        for _ in range(min(CONTIG_TAIL_STEPS, max_rounds - r)):
            st = _round_contig(fm, st, qrows, NL)
            r += 1
    return st


def _shrink_contig(st: ContigState, newE: int) -> ContigState:
    """Capacity shrink = slicing: the compaction already packed the live
    entries to the front."""
    return st._replace(kls=st.kls[:, :newE].contiguous(),
                       info=st.info[:newE], lane=st.lane[:newE])


def _pad2(n: int) -> int:
    c = 1024
    while c < n:
        c <<= 1
    return c


def run_backward_contig(fm, qrows_dev, cols_dev, n_lanes: int, x0_np,
                        minv_np, stats: "dict | None" = None):
    """Driver: a ladder of contig_rounds segments, each followed by one host
    read of the live count and a shrink, while the capacity is above
    CONTIG_FINISH_CAP; then rounds to the end. cols_dev = (kls, info,
    lane) from assemble_cols. Same contract as run_backward_flat."""
    NL = n_lanes
    dev = qrows_dev.device
    kls, info, lane = cols_dev
    L = qrows_dev.shape[1]
    active = torch.zeros(NL + 1, dtype=torch.bool, device=dev)
    active[lane.long()] = True
    st = ContigState(
        kls=kls, info=info, lane=lane,
        i=torch.from_numpy(x0_np.astype(np.int32) - 1).to(dev),
        active=active[:NL],
        last_start=torch.full((NL,), 2**31 - 1, dtype=torch.int32,
                              device=dev),
        minv=torch.from_numpy(minv_np.astype(fm.np_idt)).to(dev),
        mems_kls=kls.new_zeros((3, NL * M_CAP + 1)),
        mems_inf=torch.zeros((2, NL * M_CAP + 1), dtype=torch.int32,
                             device=dev),
        n_mems=torch.zeros(NL, dtype=torch.int32, device=dev),
        overflow=torch.zeros(NL, dtype=torch.bool, device=dev))
    seg_i = 0
    while st.lane.shape[0] > CONTIG_FINISH_CAP:
        n_rounds = SEG_SCHEDULE[min(seg_i, len(SEG_SCHEDULE) - 1)]
        seg_i += 1
        st = contig_rounds(fm, st, qrows_dev, n_rounds, NL)
        n_live = int((st.lane < NL).sum())  # one scalar crosses to the host
        if n_live == 0:
            break
        newE = _pad2(n_live)
        if newE < st.lane.shape[0]:
            st = _shrink_contig(st, newE)
    else:
        st = contig_rounds_while(fm, st, qrows_dev, L + 1, NL)
        seg_i += 1
    if stats is not None:
        stats["bwd_segments"] = stats.get("bwd_segments", 0) + seg_i
    return _pull_mems_contig(st, NL)


def _pull_mems_contig(st: ContigState, NL: int):
    """The mems in the flat engine's layout, pulled as it pulls them."""
    M = M_CAP
    mems = st.mems_kls[:, : NL * M].t().reshape(NL, M, 3)
    inf = st.mems_inf[:, : NL * M].to(torch.int64)
    infos = (inf[1] << 32) | (inf[0] & 0xFFFFFFFF)
    return _pull_mems(mems, infos.reshape(NL, M), st.n_mems, st.overflow)
