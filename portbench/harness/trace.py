"""The traced run: torch.profiler's CUDA activity over the window, reduced
to the device's busy time, the program's kernels' time, the idle gaps and
what the host was doing in them.

The window's ends are marked on the device by an anchor (a short spin
kernel) launched right after a synchronize at a known host time; the
anchors also map the host's clock onto the trace's. The profiler keeps
only device activity that it places inside its own capture, whose ends
are host times: an anchor close to either end can fall outside once the
device's clock is carried over to the host's, so the run leaves seconds
of margin between each anchor and the capture's end.
"""

from __future__ import annotations

import re

ANCHOR = "spin_kernel"
TOP = 10
MARGIN_S = 2.0  # seconds between an anchor and the capture's end


def union(intervals) -> "list[tuple[float, float]]":
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(busy, lo: float, hi: float) -> list:
    """The idle intervals of [lo, hi] between the disjoint busy ones."""
    out = []
    t = lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def open_spans(spans, t: float) -> str:
    """The names of the host spans open at t, joined, or 'no span'."""
    names = sorted({n for n, s, e in spans if s <= t <= e})
    return "+".join(names) if names else "no span"


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its trailing argument list, cut to width."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:width]


def reduce(events, anchors_host, spans, kernels) -> "dict | None":
    """Reduce device events [(name, start_s, end_s)] of the traced window.

    anchors_host: host clock() of the two anchors (window open, close);
    spans: the host spans [(name, start, end)] on that clock; kernels: the
    program's kernel names. One anchor is enough: the host clock maps
    onto the trace's by a constant. With none, "anchors" is 0, the window
    is the span of the trace's own events and its gaps are "unmapped":
    no device metric may be read from it. None when the trace holds no
    event."""
    marks = sorted((s, e) for n, s, e in events if ANCHOR in n)
    times = sorted(s for n, s, e in events if ANCHOR not in n)
    if not times:
        return None
    mid = times[len(times) // 2]
    if not marks:
        lo, hi = times[0], max(e for n, s, e in events)
        offset = None
    else:
        if marks[0][0] < mid:  # the window's opening anchor is in the trace
            offset = marks[0][0] - anchors_host[0]  # trace - host time
        else:
            offset = marks[-1][0] - anchors_host[1]
        lo = anchors_host[0] + offset + (marks[0][1] - marks[0][0])
        hi = anchors_host[1] + offset
    pat = re.compile(r"\b(" + "|".join(map(re.escape, kernels)) + r")\b")
    acts = [(n, max(s, lo), min(e, hi)) for n, s, e in events
            if ANCHOR not in n and e > lo and s < hi]
    busy = union((s, e) for _, s, e in acts)
    busy_s = sum(e - s for s, e in busy)
    by_name: dict = {}
    port = other = 0.0
    for n, s, e in acts:
        d = e - s
        by_name[short(n)] = by_name.get(short(n), 0.0) + d
        if kernels and pat.search(n):
            port += d
        else:
            other += d
    idle: dict = {}
    for s, e in gaps(busy, lo, hi):
        key = ("unmapped" if offset is None
               else open_spans(spans, (s + e) / 2 - offset))
        idle[key] = idle.get(key, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"anchors": len(marks), "window_s": hi - lo, "busy_s": busy_s,
            "port_kernel_s": port,
            "other_s": other,
            "device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in top_idle]}


def anchor_lags(events, epochs) -> "list[float]":
    """Milliseconds from each anchor's launch (host epoch seconds, as
    time.time() read it) to its start in the trace, whose clock is the
    host's epoch clock: how far the device's clock is carried over."""
    return [min((s - e for e in epochs), key=abs) * 1e3
            for n, s, _ in events if ANCHOR in n]


def device_events(prof) -> "list[tuple[str, float, float]]":
    """(name, start s, end s) of every device activity in the profile."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA"):
            out.append((ev.name(), ev.start_ns() * 1e-9, ev.end_ns() * 1e-9))
    return out
