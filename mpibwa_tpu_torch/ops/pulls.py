"""Device->host transfer of a data-dependent prefix of a tensor.

Counterpart of mpibwa_tpu/ops/pulls.py, with the same names so the
drivers read the same. There the slice length was bucketed to a power of
two to bound recompiles; torch slices any length, so a pull here is a
slice and a copy to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def pull_prefix(dev: torch.Tensor, n: int) -> np.ndarray:
    """Rows [0, n) of ``dev`` as a numpy array."""
    return dev[: max(n, 0)].cpu().numpy()


def pull_prefix_async(dev: torch.Tensor, n: int):
    """Start the [0, n) copy without blocking; returns a thunk that yields
    the numpy array. On a GPU the copy goes to pinned host memory on the
    current stream, so it waits only for the work queued before it."""
    if n <= 0 or not dev.is_cuda:
        got = pull_prefix(dev, n)
        return lambda: got
    src = dev[:n]
    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    with torch.cuda.device(dev.device):
        host.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

    def thunk():
        done.synchronize()
        return host.numpy()

    return thunk


def pack_rows(cols: torch.Tensor, emitted: torch.Tensor,
              overflow: "torch.Tensor | None" = None) -> torch.Tensor:
    """The rows of cols (E, 6) where emitted, in order, behind a header row
    [count, overflow, 0, 0, 0, 0], on the device: a (1 + E + 1, 6) tensor
    of cols' dtype, the last row a dump. overflow is a device bool, or None
    for 0. The backward engines' mems, [x0, x1, x2, start, end, lane]."""
    E = cols.shape[0]
    pos = torch.cumsum(emitted, 0)  # the row after the header
    out = torch.zeros((E + 2, 6), dtype=cols.dtype, device=cols.device)
    out[torch.where(emitted, pos, E + 1)] = cols
    out[0, 0] = emitted.sum()
    if overflow is not None:
        out[0, 1] = overflow.to(cols.dtype)
    return out


def pull_rows(packed: torch.Tensor, est_rows: int
              ) -> "tuple[np.ndarray, bool, int]":
    """(rows, overflow, host reads) of a row buffer packed on the device
    behind a header row [count, overflow, ...] (pack_rows): one pull of the
    header and the first est_rows rows, a second only when there are more;
    no rows when the header reports an overflow."""
    est = min(packed.shape[0] - 2, max(int(est_rows), 0))
    first = pull_prefix(packed, 1 + est)
    n, ov = int(first[0, 0]), bool(first[0, 1])
    if ov:
        return first[:0], True, 1
    if n <= est:
        return first[1: 1 + n], False, 1
    return pull_prefix(packed[1:], n), False, 2


def rounds_on_host(rounds: torch.Tensor, stats) -> torch.Tensor:
    """A backward pass's round count (1,) to read after its rows' pull:
    with stats on a GPU a copy to pinned host memory, which lands in stream
    order before the pull completes; else rounds itself."""
    if stats is None or not rounds.is_cuda:
        return rounds
    host = torch.empty(1, dtype=rounds.dtype, pin_memory=True)
    host.copy_(rounds, non_blocking=True)
    return host


def note_pass(stats, reads: int, rounds=None) -> None:
    """Accumulate a backward pass in stats, when given: "bwd_segments" (its
    host reads) and, where the engine counts them, "bwd_rounds"."""
    if stats is None:
        return
    stats["bwd_segments"] = stats.get("bwd_segments", 0) + reads
    if rounds is not None:
        stats["bwd_rounds"] = stats.get("bwd_rounds", 0) + int(rounds[0])


def lane_lists(rows: np.ndarray, overflow: bool, n_lanes: int):
    """(per-lane mem lists [(x0, x1, x2, start << 32 | end)], overflow
    (n_lanes,) bool) of pulled rows [x0, x1, x2, start, end, lane]: no
    mems and every lane flagged when the pass overflowed."""
    mems = [[] for _ in range(n_lanes)]
    if overflow:
        return mems, np.ones(n_lanes, bool)
    for x0, x1, x2, start, end, ln in rows.tolist():
        if 0 <= ln < n_lanes:
            mems[ln].append((x0, x1, x2, (start << 32) | end))
    return mems, np.zeros(n_lanes, bool)
