"""Command-line interface of the port, with the mpiBWA option surface.

Usage:
  python -m mpibwa_tpu_torch.cli mem [options] -o OUT <ref> <R1.fastq> [R2.fastq]
  python -m mpibwa_tpu_torch.cli membychr [options] -o OUT_DIR <ref> <R1> [R2]
  python -m mpibwa_tpu_torch.cli index|idx|merge|mergebychr ...
  python -m mpibwa_tpu_torch.cli launch -n N [--keep]
      [--hosts H1,H2|--hostfile F] [--rsh CMD] {mem|membychr} [options] ...

``mem`` and ``membychr`` align on a torch device: ``cuda`` unless
MPIBWA_TORCH_DEVICE names another (``cpu`` runs every kernel's plain
PyTorch version). MPIBWA_EXT=device runs the extension DP in the CUDA
kernel; native (the default) leaves it to the C runtime. MPIBWA_DEVICES,
MPIBWA_WORKERS, MPIBWA_SHARD/MPIBWA_NSHARDS and MPIBWA_MICROBATCH mean
what they mean for mpibwa_tpu.cli. MPIBWA_PALLAS=1 serves the FM
extension through the fused occ4 CUDA kernel (ops/occ4_cuda.py), opt-in
as in mpibwa_tpu. On a CUDA device with the int32 position path each
backward SMEM pass runs as one launch of the CUDA kernel of
ops/bwd_cuda.py, with the int64 path the v8 engine (MPIBWA_BWD=auto);
MPIBWA_BWD=flat|pallas|v8|contig picks an engine (see
pipeline/device_seed.py). Without the C runtime (no C compiler,
MPIBWA_NATIVE=0, or MPIBWA_FINAL=python) the records are finalized by the
Python route of core/, with the CIGARs and the mate rescue batched on the
device (pipeline/device_align.py); MPIBWA_CHAIN=python chains in Python.
``launch`` starts N shard processes of this module and merges their
outputs; local shards run on the same device. The package shares nothing
with mpibwa_tpu by import: the option parser and the ``index``, ``idx``,
``merge``, ``mergebychr`` and ``launch`` commands are its own copies.
"""

from __future__ import annotations

import getopt
import math
import sys

from mpibwa_tpu_torch.core import opts as O
from mpibwa_tpu_torch.core.opts import apply_preset, mem_opt_init
from mpibwa_tpu_torch.io import headers as hdr


def _split_two(arg: str):
    """bwa's 'INT[,INT]' parser (strtol, then punct + digit check)."""
    i = 1 if arg[:1] in ("+", "-") else 0
    while i < len(arg) and arg[i].isdigit():
        i += 1
    v1 = int(arg[:i])
    if (i < len(arg) and not arg[i].isalnum() and i + 1 < len(arg)
            and arg[i + 1].isdigit()):
        j = i + 1
        while j < len(arg) and arg[j].isdigit():
            j += 1
        return v1, int(arg[i + 1 : j])
    return v1, None


def main_mem(argv, by_chr: bool = False):
    opt = mem_opt_init()
    explicitly = set()
    mode = None
    file_out = None
    verbose = 3  # bwa_verbose default (mainParallel.c:478)
    write_format = 2  # SAM
    dofixmate = False
    copy_comment = False
    fixed_chunk_size = 0
    hdr_line = None
    rg_line = None
    rg_id = ""
    shared_mem = None
    ignore_alt = False
    pes0 = None

    optstr = "bg51qpaMCSPVYjk:K:c:v:s:r:t:R:A:B:O:E:U:w:L:d:T:Q:D:m:I:N:W:x:G:h:y:X:H:o:z:f"
    try:
        optlist, args = getopt.getopt(argv, optstr)
    except getopt.GetoptError as e:
        print(f"option error: {e}", file=sys.stderr)
        return 1

    def seti(name, v):
        setattr(opt, name, v)
        explicitly.add(name)

    for c, a in optlist:
        c = c[1:]
        if c == "k":
            seti("min_seed_len", int(a))
        elif c == "1":
            pass
        elif c == "x":
            mode = a
        elif c == "w":
            seti("w", int(a))
        elif c == "A":
            seti("a", int(a))
        elif c == "B":
            seti("b", int(a))
        elif c == "b":
            write_format = 1
        elif c == "g":
            write_format = 0
        elif c == "z":
            shared_mem = a
        elif c == "T":
            seti("T", int(a))
        elif c == "U":
            seti("pen_unpaired", int(a))
        elif c == "t":
            opt.n_threads = max(int(a), 1)
        elif c == "P":
            opt.flag |= O.MEM_F_NOPAIRING
        elif c == "a":
            opt.flag |= O.MEM_F_ALL
        elif c == "p":
            opt.flag |= O.MEM_F_PE | O.MEM_F_SMARTPE
        elif c == "M":
            opt.flag |= O.MEM_F_NO_MULTI
        elif c == "S":
            opt.flag |= O.MEM_F_NO_RESCUE
        elif c == "Y":
            opt.flag |= O.MEM_F_SOFTCLIP
        elif c == "V":
            opt.flag |= O.MEM_F_REF_HDR
        elif c == "5":
            opt.flag |= O.MEM_F_PRIMARY5 | O.MEM_F_KEEP_SUPP_MAPQ
        elif c == "q":
            opt.flag |= O.MEM_F_KEEP_SUPP_MAPQ
        elif c == "c":
            seti("max_occ", int(a))
        elif c == "d":
            seti("zdrop", int(a))
        elif c == "v":
            verbose = int(a)
            O.bwa_verbose = verbose
        elif c == "j":
            ignore_alt = True
        elif c == "r":
            seti("split_factor", float(a))
        elif c == "D":
            seti("drop_ratio", float(a))
        elif c == "m":
            seti("max_matesw", int(a))
        elif c == "s":
            seti("split_width", int(a))
        elif c == "G":
            seti("max_chain_gap", int(a))
        elif c == "N":
            seti("max_chain_extend", int(a))
        elif c == "W":
            seti("min_chain_weight", int(a))
        elif c == "y":
            seti("max_mem_intv", int(a))
        elif c == "C":
            copy_comment = True
        elif c == "K":
            fixed_chunk_size = int(a)
        elif c == "X":
            opt.mask_level = float(a)
        elif c == "h":
            explicitly.add("max_XA_hits")
            explicitly.add("max_XA_hits_alt")
            parts = a.replace(";", ",").split(",")
            opt.max_XA_hits = opt.max_XA_hits_alt = int(parts[0])
            if len(parts) > 1 and parts[1]:
                opt.max_XA_hits_alt = int(parts[1])
        elif c == "Q":
            explicitly.add("mapQ_coef_len")
            opt.mapQ_coef_len = float(int(a))
            opt.mapQ_coef_fac = int(math.log(opt.mapQ_coef_len)) \
                if opt.mapQ_coef_len > 0 else 0
        elif c == "O":
            explicitly.add("o_del")
            explicitly.add("o_ins")
            v1, v2 = _split_two(a)
            opt.o_del = opt.o_ins = v1
            if v2 is not None:
                opt.o_ins = v2
        elif c == "E":
            explicitly.add("e_del")
            explicitly.add("e_ins")
            v1, v2 = _split_two(a)
            opt.e_del = opt.e_ins = v1
            if v2 is not None:
                opt.e_ins = v2
        elif c == "L":
            explicitly.add("pen_clip5")
            explicitly.add("pen_clip3")
            v1, v2 = _split_two(a)
            opt.pen_clip5 = opt.pen_clip3 = v1
            if v2 is not None:
                opt.pen_clip3 = v2
        elif c == "R":
            rg_line, rg_id = hdr.bwa_set_rg(a)
        elif c == "H":
            if a.startswith("@"):
                hdr_line = hdr.insert_header(a, hdr_line)
            else:
                with open(a) as fh:
                    for line in fh:
                        hdr_line = hdr.insert_header(line.rstrip("\n"), hdr_line)
        elif c == "I":
            from mpibwa_tpu_torch.core.pair import PEStat

            pes0 = [PEStat(failed=1) for _ in range(4)]
            parts = a.replace(";", ",").split(",")
            p = pes0[1]
            p.failed = 0
            p.avg = float(parts[0])
            p.std = p.avg * 0.1
            if len(parts) > 1 and parts[1]:
                p.std = float(parts[1])
            p.high = int(p.avg + 4.0 * p.std + 0.499)
            p.low = max(int(p.avg - 4.0 * p.std + 0.499), 1)
            if len(parts) > 2 and parts[2]:
                p.high = int(float(parts[2]) + 0.499)
            if len(parts) > 3 and parts[3]:
                p.low = int(float(parts[3]) + 0.499)
        elif c == "o":
            file_out = a
        elif c == "f":
            dofixmate = True
        else:
            return 1

    if fixed_chunk_size <= 0:
        fixed_chunk_size = opt.chunk_size * opt.n_threads
    if mode is not None:
        apply_preset(opt, mode, explicitly)
    else:
        from mpibwa_tpu_torch.core.opts import rescale_by_a

        rescale_by_a(opt, explicitly, preset=None)
    opt.mat = O.fill_scmat(opt.a, opt.b)
    opt.round_float_fields()

    if len(args) not in (2, 3) or file_out is None:
        print("usage: mem [options] -o OUT REF R1.fastq [R2.fastq]",
              file=sys.stderr)
        return 1
    ref, r1 = args[0], args[1]
    r2 = args[2] if len(args) == 3 else None
    pg_line = hdr.make_pg_line(["mpibwa-tpu", "mem"] + list(argv))

    from mpibwa_tpu_torch.index.format import load_image, load_index
    import os

    # preflight with exit(2) messages (mainParallel.c:604-633)
    if not (os.path.exists(ref + ".tpumap")
            or all(os.path.exists(ref + e)
                   for e in (".bwt", ".sa", ".ann", ".amb", ".pac"))):
        print(f"[E::main_mem] index not found: need {ref}.tpumap or the "
              f"bwa index files {ref}.{{bwt,sa,ann,amb,pac}} "
              f"(run `cli index` then `cli idx`)", file=sys.stderr)
        return 2
    for fq in (r1, r2):
        if fq is not None and not os.path.isfile(fq):
            print(f"[E::main_mem] input not found: {fq}", file=sys.stderr)
            return 2
    out_parent = os.path.dirname(os.path.abspath(file_out))
    if not os.path.isdir(out_parent):
        print(f"[E::main_mem] output directory does not exist: {out_parent}",
              file=sys.stderr)
        return 2

    if os.path.exists(ref + ".tpumap"):
        # -z picks the host-side index replication granularity, the analog
        # of map_indexes' placement domains (parallel_aux.c:1779-1807):
        # every domain except "core" means ONE physical copy shared by the
        # co-located shard processes — here a read-only mmap of the flat
        # image, deduplicated by the page cache (the np.memmap equivalent
        # of the reference's MPI_Win_allocate_shared window). "core" =
        # replicate per process (a private read, the reference's most
        # granular domain).
        idx = load_image(ref + ".tpumap", mmap=shared_mem != "core")
    else:
        idx = load_index(ref)
    if ignore_alt:
        for a_ in idx.anns:
            a_.is_alt = 0

    from mpibwa_tpu_torch.parallel.runtime import Runtime

    # intra-host data parallelism: MPIBWA_DEVICES=all|N fans chunks out over
    # the visible GPUs; -t maps to pipelined workers per device
    # (MPIBWA_WORKERS overrides); the reference's -t also sets the default
    # -K, which is preserved above
    from mpibwa_tpu_torch.device import list_devices

    devices = None
    dev_env = os.environ.get("MPIBWA_DEVICES", "")
    workers = (int(os.environ.get("MPIBWA_WORKERS", "0"))
               or min(max(opt.n_threads, 1), 4))
    if workers > 1 and not dev_env:
        dev_env = "1"
    if dev_env:
        avail = list_devices()
        if dev_env == "all":
            devices = avail
        else:
            try:
                devices = avail[: int(dev_env)]
            except ValueError:
                print(f"[E::main_mem] MPIBWA_DEVICES must be 'all' or an "
                      f"integer, got {dev_env!r}", file=sys.stderr)
                return 1
        devices = [d for d in devices for _ in range(max(workers, 1))]

    # multi-process sharding (the `mpirun -n N` analog): launch one process
    # per shard with MPIBWA_SHARD=i MPIBWA_NSHARDS=N, then `cli merge`
    # (mainParallel.c's rank-round-robin chunk assignment, :1200-1260)
    shard = int(os.environ.get("MPIBWA_SHARD", "0"))
    n_shards = int(os.environ.get("MPIBWA_NSHARDS", "1"))
    rt = Runtime(idx, opt,
                 fixed_chunk_size=fixed_chunk_size, devices=devices,
                 shard=shard, n_shards=n_shards, verbose=verbose >= 3)
    if by_chr:
        # sharded runs write complete per-shard directories merged by
        # `cli mergebychr` (the mpiBWAByChr write stage,
        # mainParallelByChromosome.c:1462-1563, distributes through a
        # shared file pointer; we distribute through per-shard extents)
        out_dir = (f"{file_out}.shard{shard}" if n_shards > 1 else file_out)
        paths = rt.run_by_chr(r1, r2, out_dir, write_format, dofixmate,
                              hdr_line, rg_line, pg_line, rg_id, copy_comment,
                              pes0)
        if n_shards > 1:
            import json

            with open(os.path.join(out_dir, "manifest.json"), "w") as mf:
                json.dump({"shard": shard, "n_shards": n_shards,
                           "header_len": rt.header_len,
                           "format": write_format,
                           "files": rt.out_files,
                           "times": rt.times,
                           "manifest": rt.last_manifest}, mf)
        if verbose >= 3:
            print(f"wrote {len(paths)} by-chromosome outputs under "
                  f"{out_dir}", file=sys.stderr)
    else:
        path = rt.run(r1, r2, file_out, write_format, dofixmate, hdr_line,
                      rg_line, pg_line, rg_id, copy_comment, pes0)
        if n_shards > 1:
            import json

            with open(path + ".manifest.json", "w") as mf:
                json.dump({"shard": shard, "n_shards": n_shards,
                           "header_len": rt.header_len,
                           "format": write_format,
                           "times": rt.times,
                           "manifest": rt.last_manifest}, mf)
        if verbose >= 3:
            print(f"output written to {path}", file=sys.stderr)
    return 0


def main_index(argv):
    from mpibwa_tpu_torch.index.build import build_index

    if not argv:
        print("usage: index <ref.fasta>", file=sys.stderr)
        return 1
    build_index(argv[0])
    return 0


def main_idx(argv):
    """mpiBWAIdx equivalent: pack the index into the flat image."""
    from mpibwa_tpu_torch.index.format import load_index, save_image

    if not argv:
        print("usage: idx <ref.fasta>", file=sys.stderr)
        return 1
    idx = load_index(argv[0])
    save_image(idx, argv[0] + ".tpumap")
    print(f"wrote {argv[0]}.tpumap", file=sys.stderr)
    return 0


def main_merge(argv):
    """Merge per-shard outputs (written with MPIBWA_SHARD/MPIBWA_NSHARDS)
    into one file in deterministic chunk order: cli merge OUT SHARD0 SHARD1…
    (each SHARDk must have its .manifest.json sidecar next to it)."""
    import json

    from mpibwa_tpu_torch.parallel.runtime import merge_shard_outputs

    if len(argv) < 2:
        print("usage: merge <out_file> <shard0_out> [<shard1_out> ...]",
              file=sys.stderr)
        return 1
    out, shard_paths = argv[0], argv[1:]
    sidecars = []
    for sp in shard_paths:
        with open(sp + ".manifest.json") as mf:
            sidecars.append(json.load(mf))
    sidecars_by_shard = sorted(zip(sidecars, shard_paths),
                               key=lambda t: t[0]["shard"])
    n = sidecars_by_shard[0][0]["n_shards"]
    if len(shard_paths) != n or [m["shard"] for m, _ in sidecars_by_shard] \
            != list(range(n)):
        print(f"[E::merge] expected {n} shards 0..{n-1}, got "
              f"{sorted(m['shard'] for m in sidecars)}", file=sys.stderr)
        return 1
    merge_shard_outputs([p for _, p in sidecars_by_shard],
                        [m["manifest"] for m, _ in sidecars_by_shard],
                        out, sidecars_by_shard[0][0]["header_len"],
                        sidecars_by_shard[0][0].get("format", 2))
    _print_aggregate_times([m for m, _ in sidecars_by_shard])
    print(f"merged {n} shards into {out}", file=sys.stderr)
    return 0


def _print_aggregate_times(sidecars):
    """Aggregate per-shard phase times like the reference's end-of-run
    Allreduce summary (mainParallel.c:3266-3291): min/avg/max per phase."""
    times = [m.get("times") for m in sidecars]
    if not all(isinstance(t, dict) for t in times):
        return
    keys = sorted({k for t in times for k in t})
    for k in keys:
        vs = [float(t.get(k, 0.0)) for t in times]
        print(f"[M::merge] {k} time across {len(vs)} shards: "
              f"min {min(vs):.2f}s avg {sum(vs) / len(vs):.2f}s "
              f"max {max(vs):.2f}s", file=sys.stderr)


def main_merge_bychr(argv):
    """Merge per-shard by-chromosome directories (written with membychr +
    MPIBWA_SHARD/MPIBWA_NSHARDS): cli mergebychr OUT_DIR SHARD_DIR0 …"""
    import json
    import os

    from mpibwa_tpu_torch.parallel.runtime import merge_bychr_outputs

    if len(argv) < 2:
        print("usage: mergebychr <out_dir> <shard_dir0> [<shard_dir1> ...]",
              file=sys.stderr)
        return 1
    out_dir, shard_dirs = argv[0], argv[1:]
    sidecars = []
    for d in shard_dirs:
        with open(os.path.join(d, "manifest.json")) as mf:
            sidecars.append(json.load(mf))
    by_shard = sorted(zip(sidecars, shard_dirs), key=lambda t: t[0]["shard"])
    n = by_shard[0][0]["n_shards"]
    if len(shard_dirs) != n or [m["shard"] for m, _ in by_shard] \
            != list(range(n)):
        print(f"[E::mergebychr] expected {n} shards 0..{n-1}, got "
              f"{sorted(m['shard'] for m in sidecars)}", file=sys.stderr)
        return 1
    paths = merge_bychr_outputs([d for _, d in by_shard],
                                [m["manifest"] for m, _ in by_shard],
                                by_shard[0][0]["files"], out_dir,
                                by_shard[0][0]["header_len"],
                                by_shard[0][0].get("format", 2))
    print(f"merged {n} shards into {len(paths)} files under {out_dir}",
          file=sys.stderr)
    return 0


def main_launch(argv):
    """One-command distribution (the `mpirun -n N mpiBWA` analog):

      cli launch -n N [--keep] [--hosts H1,H2|--hostfile F] [--rsh CMD]
                 {mem|membychr} [options] -o OUT REF R1 [R2]

    Spawns N shard processes (MPIBWA_SHARD=i, MPIBWA_NSHARDS=N), waits,
    merges their outputs deterministically, and removes the shard files.
    With --hosts/--hostfile, shards round-robin over the hosts via --rsh
    (default ssh), like `mpirun -hostfile` (mainParallel.c:517-519); the
    inputs and OUT path must live on a shared filesystem, exactly as the
    reference requires for its MPI-IO output. "localhost" entries spawn
    local process groups (no ssh), which is also how the integration test
    exercises this path."""
    import os
    import shlex
    import subprocess

    keep = False
    n = None
    hosts = []
    rsh = "ssh"
    i = 0
    while i < len(argv) and argv[i] in ("-n", "--keep", "--hosts",
                                        "--hostfile", "--rsh"):
        if argv[i] == "--keep":
            keep = True
            i += 1
            continue
        if i + 1 >= len(argv):
            break
        if argv[i] == "-n":
            n = int(argv[i + 1])
        elif argv[i] == "--hosts":
            hosts = [h for h in argv[i + 1].split(",") if h]
        elif argv[i] == "--hostfile":
            with open(argv[i + 1]) as hf:
                hosts = [ln.split()[0] for ln in hf
                         if ln.strip() and not ln.startswith("#")]
        elif argv[i] == "--rsh":
            rsh = argv[i + 1]
        i += 2
    rest = argv[i:]
    if n is None and hosts:
        n = len(hosts)
    if n is None or n < 1 or not rest or rest[0] not in ("mem", "membychr"):
        print("usage: launch -n N [--keep] [--hosts H1,H2|--hostfile F] "
              "[--rsh CMD] {mem|membychr} [options] -o OUT REF R1 [R2]",
              file=sys.stderr)
        return 1
    sub, sub_args = rest[0], rest[1:]
    # -f is main_mem's alias for -o (mainParallel.c getopt surface)
    out_flag = "-o" if "-o" in sub_args else "-f"
    try:
        out = sub_args[sub_args.index(out_flag) + 1]
    except (ValueError, IndexError):
        print("[E::launch] -o OUT is required", file=sys.stderr)
        return 1
    write_format = 2
    if "-b" in sub_args:
        write_format = 1
    elif "-g" in sub_args:
        write_format = 0
    by_chr = sub == "membychr"

    if n == 1:
        return main_mem(sub_args, by_chr=by_chr)

    procs = []
    for k in range(n):
        env = dict(os.environ, MPIBWA_SHARD=str(k), MPIBWA_NSHARDS=str(n))
        args = list(sub_args)
        if not by_chr:
            # per-shard output files; merged into OUT afterwards
            args[args.index(out_flag) + 1] = f"{out}.shard{k}"
        cmd = [sys.executable, "-m", "mpibwa_tpu_torch.cli", sub] + args
        host = hosts[k % len(hosts)] if hosts else "localhost"
        if host in ("localhost", "127.0.0.1"):
            procs.append(subprocess.Popen(cmd, env=env))
        else:
            # remote shard: env rides the command line; the MPIBWA_* knobs
            # (MPIBWA_TORCH_DEVICE among them) and the device-selection
            # variables of this process propagate (mpirun forwards the
            # launcher environment to every rank; a remote shard that
            # silently picked another device would be a correctness
            # hazard, not just slow). python resolves to the remote PATH.
            envs = [f"MPIBWA_SHARD={k}", f"MPIBWA_NSHARDS={n}"]
            envs += [f"{key}={shlex.quote(v)}"
                     for key, v in os.environ.items()
                     if (key.startswith("MPIBWA_")
                         or key in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES"))
                     and key not in ("MPIBWA_SHARD", "MPIBWA_NSHARDS")]
            rcmd = (f"cd {shlex.quote(os.getcwd())} && env " + " ".join(envs)
                    + " python3 -m mpibwa_tpu_torch.cli " + sub + " "
                    + " ".join(shlex.quote(a) for a in args))
            procs.append(subprocess.Popen(shlex.split(rsh) + [host, rcmd]))
    rc = 0
    for k, p in enumerate(procs):
        r = p.wait()
        if r != 0:
            print(f"[E::launch] shard {k} exited with {r}", file=sys.stderr)
            rc = r
    if rc != 0:
        return rc

    ext = {2: ".sam", 1: ".bam", 0: ".gz"}[write_format]
    if by_chr:
        shard_dirs = [f"{out}.shard{k}" for k in range(n)]
        rc = main_merge_bychr([out] + shard_dirs)
        if rc == 0 and not keep:
            import shutil

            for d in shard_dirs:
                shutil.rmtree(d)
    else:
        shard_paths = [f"{out}.shard{k}{ext}" for k in range(n)]
        rc = main_merge([out + ext] + shard_paths)
        if rc == 0 and not keep:
            for p_ in shard_paths:
                os.remove(p_)
                os.remove(p_ + ".manifest.json")
    return rc


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: mpibwa_tpu_torch.cli {mem|membychr|index|idx|merge|"
              "mergebychr|launch} ...", file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "mem":
        return main_mem(rest)
    if cmd in ("membychr", "mem-by-chr"):
        return main_mem(rest, by_chr=True)
    host_cmds = {"index": main_index, "idx": main_idx, "merge": main_merge,
                 "mergebychr": main_merge_bychr}
    if cmd in host_cmds:
        return host_cmds[cmd](rest)
    if cmd == "launch":
        return main_launch(rest)
    print(f"unsupported command: {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
