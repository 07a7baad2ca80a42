"""The window's arithmetic, the sink and the trace reduction."""

import time

import numpy as np
import pytest

from harness import trace as T
from harness.simulate import Pool, pair_name, read_name
from harness.window import Sink, run_window, worker_chunks


def _records(first, n_pairs):
    return [pair_name(first + (i >> 1)) + b"\t0\n" for i in range(2 * n_pairs)]


def _pool(first, units, per_unit=2, name=pair_name):
    return Pool(None, [], np.asarray(first), np.asarray(units), per_unit,
                [0] * len(first), name)


def test_workers_take_chunks_round_robin_over_the_cycled_pool():
    it = worker_chunks(1, 4, 6, first=4)
    assert [next(it) for _ in range(4)] == [(1, 5), (5, 3), (9, 1), (13, 5)]


def test_no_chunk_starts_after_the_window_and_all_started_finish():
    first = np.array([0, 10, 20]), np.array([10, 10, 10])
    starts = []

    def chunk(w, ci):
        starts.append(time.perf_counter())
        time.sleep(0.05)
        return _records(int(first[0][ci]), 10), 0.001

    sink = Sink(_pool(*first), 3, 2)
    win = run_window(chunk, [0, 1], 3, 0.3, sink)
    assert max(starts) < win.start + 0.3
    assert win.end >= max(starts) + 0.05
    assert win.chunks == len(starts) and win.reads == 20 * len(starts)
    assert win.attempted == win.reads and sink.missing == 0
    assert abs(win.parse_s - 0.001 * win.chunks) < 1e-9
    assert abs(win.rate - win.reads / (win.end - win.start)) < 1e-6


def test_cpu_time_counts_the_workers_work_and_not_their_sleep():
    first = np.array([0, 10]), np.array([10, 10])

    def chunk(w, ci):
        t = time.thread_time()
        while time.thread_time() - t < 0.05:  # this thread's work
            pass
        time.sleep(0.1)  # a wait on the device or a file costs no CPU
        return _records(int(first[0][ci]), 10), 0.0

    win = run_window(chunk, [0, 1], 2, float("inf"), Sink(_pool(*first), 3, 0),
                     max_rounds=2)
    assert win.chunks == 4
    assert 0.2 <= win.cpu_s < 0.2 + 0.1 * win.chunks


def test_tail_idle_counts_each_workers_wait_for_the_last_chunk():
    from harness.window import Window

    w = Window(reads=40, attempted=40, chunks=4, start=10.0, end=20.0,
               parse_s=0.0, worker_ends=[20.0, 18.0, 15.0, 10.0])
    # idle 0 + 2 + 5 + 10 worker-seconds of 4 x 10
    assert w.tail_idle_pct == pytest.approx(100.0 * 17 / 40)


def test_warm_up_takes_one_chunk_a_worker():
    first = np.array([0, 10, 20]), np.array([10, 10, 10])
    seen = []

    def chunk(w, ci):
        seen.append((w, ci))
        return _records(int(first[0][ci]), 10), 0.0

    run_window(chunk, ["a", "b"], 3, float("inf"), Sink(_pool(*first), 3, 0),
               max_rounds=1)
    assert sorted(seen) == [("a", 0), ("b", 1)]


def test_sink_counts_missing_and_misnamed_records_and_samples():
    sink = Sink(_pool([0, 8], [8, 8]), 11, 3)
    recs = _records(8, 8)
    recs[3] = b""
    recs[5] = pair_name(0) + b"\t0\n"
    assert sink.put(0, 1, recs[:14]) == 4
    assert sink.missing == 4
    got = sink.sample(2)
    assert len(got) == 2 and all(8 <= p < 16 for p, _, _ in got)
    assert sink.sample(2) == got


def test_sink_takes_single_reads_with_supplementary_lines():
    full = [read_name(5 + i) + b"\t0\n" for i in range(7)]
    full[2] += read_name(7) + b"\t2048\n"  # a supplementary line
    sink = Sink(_pool([0, 5], [5, 7], 1, read_name), 11, 7)
    assert sink.reads.tolist() == [5, 7]
    assert sink.put(0, 1, full) == 0
    assert (7, full[2].decode()) in sink.sample(7)
    dropped = full[:4] + full[5:]  # read 9's record left out
    assert sink.put(1, 1, dropped) == 3  # it and the two after it
    assert sink.missing == 3


def test_union_gaps_and_open_spans():
    u = T.union([(0, 2), (1, 3), (5, 6), (6, 7), (9, 9)])
    assert u == [(0, 3), (5, 7)]
    assert T.gaps(u, -1, 10) == [(-1, 0), (3, 5), (7, 10)]
    spans = [("chain", 0, 4), ("seed", 3, 6)]
    assert T.open_spans(spans, 3.5) == "chain+seed"
    assert T.open_spans(spans, 8) == "no span"


def test_reduce_measures_between_the_anchors():
    ev = [("spin_kernel(long)", 100.0, 100.1),
          ("void bwd_pass_kernel<4>(int)", 100.2, 100.5),
          ("void at::native::fill(int)", 100.4, 100.6),
          ("Memcpy DtoH", 101.0, 101.1),
          ("spin_kernel(long)", 102.1, 102.2),
          ("void sa_walk_kernel(int)", 103.0, 104.0)]
    spans = [("emit", 0.6, 1.0), ("seed", 1.05, 1.2)]
    r = T.reduce(ev, (0.0, 2.1), spans, ["bwd_pass_kernel", "sa_walk_kernel"])
    assert r["anchors"] == 2
    assert abs(r["window_s"] - 2.0) < 1e-9
    assert abs(r["busy_s"] - 0.5) < 1e-9  # [100.2, 100.6] + [101, 101.1]
    assert abs(r["port_kernel_s"] - 0.3) < 1e-9
    assert abs(r["other_s"] - 0.3) < 1e-9
    idle = dict(r["idle_gaps"])
    assert abs(idle["emit"] - 0.4) < 1e-9  # [100.6, 101.0]
    assert abs(idle["no span"] - 1.1) < 1e-9  # [100.1, 100.2] and [101.1, 102.1]
    assert r["device_ops"][0][0] == "void bwd_pass_kernel<4>"
    # either anchor alone maps the host's clock and the window the same
    for kept in (ev[:4] + ev[5:], ev[1:]):
        one = T.reduce(kept, (0.0, 2.1), spans,
                       ["bwd_pass_kernel", "sa_walk_kernel"])
        assert one["anchors"] == 1
        assert abs(one["window_s"] - 2.0) < 1e-9
        assert abs(one["busy_s"] - 0.5) < 1e-9
        assert dict(one["idle_gaps"]) == pytest.approx(idle)
    # no anchor: the events' own span, gaps unmapped, and no anchor to
    # read a device metric by
    bare = T.reduce(ev[1:4], (0.0, 1.0), spans, [])
    assert bare["anchors"] == 0
    assert abs(bare["window_s"] - 0.9) < 1e-9
    assert abs(bare["busy_s"] - 0.5) < 1e-9
    assert dict(bare["idle_gaps"]) == pytest.approx({"unmapped": 0.4})
    assert T.reduce([], (0.0, 1.0), spans, []) is None


def test_anchor_lags_match_each_anchor_to_its_launch():
    ev = [("spin_kernel(long)", 100.0002, 100.1), ("fill", 100.5, 100.6),
          ("spin_kernel(long)", 160.0001, 160.1)]
    lags = T.anchor_lags(ev, (100.0, 160.0))
    assert lags == pytest.approx([0.2, 0.1])
