#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, in one process.

    python3 portbench/calibrate.py --workload int32.pe101 --seconds 12 \
        --seeds 11,12,13 --control-seeds 21,22,23 [--control w=0]

Set-up runs once. Then each seed's pool goes through a warm-up and a
window of --seconds, as in a run, and the reference's numbers are printed
(one JSON line a seed, "side": "program"). The control is the program with
one guarantee of the configuration broken (--control: mem options as
key=value; by default -w 0: a band of 0, an ungapped extension, where the
configuration states bwa's -w 100), run the same way on the control seeds
("side": "control"). Only the first window of each side warms up.
--rehearse runs it on the CPU at the rehearsal's tiny genome.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control", default="w=0")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]
    import run as run_mod

    run_mod.caches()
    import torch

    from harness import cell as C
    from harness import program
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    if args.rehearse:
        os.environ["MPIBWA_TORCH_DEVICE"] = "cpu"
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("[calibrate] no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    s = C.Setup(cell, device, args.rehearse)
    ctrl = dict(s.options)
    for kv in filter(None, args.control.split(",")):
        k, v = kv.split("=")
        ctrl[k] = int(v)
    twins = s.workers.twins(program.make_opt(ctrl))
    n_sample = (C.REHEARSAL["sample_pairs"] if args.rehearse
                else int(cell.traffic["sample_pairs"]))
    limits = C.limits_of(cell)
    warmed = None
    try:
        for side, aligners, seeds in (
                ("program", s.aligners, args.seeds),
                ("control", twins, args.control_seeds)):
            for seed in [int(x) for x in filter(None, seeds.split(","))]:
                t0 = time.time()
                win, sink, pairs, _, _, _ = s.window(
                    aligners, seed, args.seconds, warm=aligners is not warmed)
                warmed = aligners
                nums = s.check(sink, pairs, n_sample)
                correct, _ = C.judge(nums, limits)
                print(json.dumps({"side": side, "seed": seed,
                                  "correct": correct, "reads": win.reads,
                                  "reads_per_s": win.rate,
                                  "wall_s": time.time() - t0, **nums}),
                      flush=True)
    finally:
        s.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
