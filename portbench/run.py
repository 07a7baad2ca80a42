#!/usr/bin/env python3
"""The benchmark of mpibwa_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload int32.pe101 --seed 7 --seconds 30 \
        --trace 0

from the root of a checkout, on a machine with the cell's GPUs. It prints
the checks as the last lines of standard error and, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics; with --trace 1 its per-layer metrics),
device (and with --trace 1 breakdown), then checks. Without a usable GPU
it exits with 2 and prints no result. --rehearse runs the same path on the
CPU at a tiny genome and prints no metric.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def process_start() -> float:
    """The process's start on the time.time() clock (/proc), or now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    no library pulls in JAX."""
    base = os.path.join(ROOT, "build", "portbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    t_epoch = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU, tiny genome, no metrics")
    args = ap.parse_args(argv)
    caches()
    sys.path[:0] = [ROOT, HERE]
    from harness import cell as C
    from harness.spec import load_cell
    from harness.window import clock

    t_proc = clock() - (time.time() - t_epoch)
    cell = load_cell(args.workload)
    import torch

    if args.rehearse:
        os.environ["MPIBWA_TORCH_DEVICE"] = "cpu"
    elif not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    out, lines = C.measure(cell, args.seed, args.seconds, bool(args.trace),
                           args.rehearse, t_proc)
    for line in lines:
        print(line, file=sys.stderr)
    if out is None:
        return 3
    import json

    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
