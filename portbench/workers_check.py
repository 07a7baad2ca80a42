#!/usr/bin/env python3
"""Whether the cell's workers change the output: `cli mem` with the
configuration's -t against -t 1, on the same seed's chunks.

    python3 portbench/workers_check.py --workload int32.pe101 --seed 5 \
        --chunks 4 [--rehearse]

Chunk boundaries depend only on -K, so the SAM (less its @PG line, which
holds the command) must be byte-identical. Prints one JSON line: same,
the bytes compared and each run's wall seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]
    import run as run_mod

    run_mod.caches()
    from harness import cell as C
    from harness.simulate import fastq_bytes, pairs_per_chunk, simulate_pairs
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    cfg = cell.config
    if cfg["positions"] != "int32":
        print("[workers_check] the CLI has no switch for int64 positions",
              file=sys.stderr)
        return 2
    n = (C.REHEARSAL["genome_length"] if args.rehearse
         else int(cfg["genome_length"]))
    codes, ref = C.reference_genome(cfg["genome"], n)
    K = C.REHEARSAL["K"] if args.rehearse else int(cfg["chunk_bases"])
    per = pairs_per_chunk(K, int(cell.traffic["read_len"]))
    pairs = simulate_pairs(codes, args.chunks * per,
                           C.seed_entropy(args.seed), cell.traffic)
    env = dict(os.environ)
    if args.rehearse:
        env["MPIBWA_TORCH_DEVICE"] = "cpu"
    out = {}
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        fq = []
        for m, reads in ((1, pairs.r1), (2, pairs.r2)):
            fq.append(os.path.join(tmp, f"r{m}.fq"))
            with open(fq[-1], "wb") as fh:
                fh.write(fastq_bytes(reads, 0))
        sams = {}
        for t in (int(cfg["mem_options"]["t"]), 1):
            o = os.path.join(tmp, f"t{t}")
            t0 = time.time()
            subprocess.run([sys.executable, "-m", "mpibwa_tpu_torch.cli",
                            "mem", "-t", str(t), "-K", str(K), "-v", "1",
                            "-o", o, ref] + fq, check=True, cwd=ROOT,
                           env=env)
            out[f"t{t}_s"] = time.time() - t0
            with open(o + ".sam", "rb") as fh:
                sams[t] = b"".join(ln for ln in fh
                                   if not ln.startswith(b"@PG"))
        a, b = sams.values()
        out.update(same=a == b, bytes=len(a), reads=2 * len(pairs))
    print(json.dumps(out), flush=True)
    return 0 if out["same"] else 1


if __name__ == "__main__":
    sys.exit(main())
