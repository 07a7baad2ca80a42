"""The port stands on its own: no module of mpibwa_tpu_torch (nor
chip_smoke.py) imports jax or mpibwa_tpu, its CLI runs index, idx, mem,
membychr, merge, mergebychr and launch in a process that loads neither,
and its ``index`` writes the same files as mpibwa_tpu's."""

import ast
import os
import subprocess
import sys

import pytest

import _torch_toy as toy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDEX_EXTS = (".amb", ".ann", ".pac", ".bwt", ".sa")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "mpibwa_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _foreign(name: "str | None") -> bool:
    top = (name or "").split(".")[0]
    return top in ("jax", "jaxlib", "mpibwa_tpu")


def test_no_source_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 30  # the package with its own core/, io/, ...
    bad = []
    for path in sources:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno}: {n}"
                    for n in names if _foreign(n)]
    assert not bad, "\n".join(bad)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("standalone")
    contigs = toy.make_genome()
    toy.write_fasta(str(d / "toy.fa"), contigs)
    r1, r2 = toy.simulate_pairs(contigs, 120)
    toy.write_fastq(str(d / "r1.fq"), r1)
    toy.write_fastq(str(d / "r2.fq"), r2)
    return d


_SCRIPT = r"""
import os, sys
from mpibwa_tpu_torch import cli

def run(argv, **env):
    os.environ.update(env)
    rc = cli.main(argv)
    assert rc == 0, (argv, rc)

ref, r1, r2 = "toy.fa", "r1.fq", "r2.fq"
run(["index", ref])
run(["idx", ref])
K = ["-t", "1", "-K", "6000", "-v", "1"]
run(["mem"] + K + ["-o", "whole", ref, r1, r2])
for k in ("0", "1"):
    run(["mem"] + K + ["-o", "part" + k, ref, r1, r2],
        MPIBWA_SHARD=k, MPIBWA_NSHARDS="2")
    run(["membychr"] + K + ["-o", "bychr", ref, r1, r2],
        MPIBWA_SHARD=k, MPIBWA_NSHARDS="2")
os.environ.update(MPIBWA_SHARD="0", MPIBWA_NSHARDS="1")
run(["merge", "merged.sam", "part0.sam", "part1.sam"])
run(["mergebychr", "bychr_merged", "bychr.shard0", "bychr.shard1"])
run(["membychr"] + K + ["-o", "bychr_whole", ref, r1, r2])
L2 = ["launch", "-n", "2", "--hosts", "localhost,localhost"]
run(L2 + ["mem"] + K + ["-o", "launched", ref, r1, r2])
run(L2 + ["membychr"] + K + ["-o", "bychr_launched", ref, r1, r2])
run(["launch", "-n", "1", "mem"] + K + ["-o", "launched1", ref, r1, r2])
run(["launch", "-n", "2", "--keep", "mem"] + K + ["-o", "kept", ref, r1, r2])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mpibwa_tpu"))
assert not loaded, loaded
print("standalone ok")
"""


@pytest.fixture(scope="module")
def standalone_run(fasta):
    env = dict(os.environ, MPIBWA_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    for k in ("MPIBWA_SHARD", "MPIBWA_NSHARDS", "MPIBWA_BWD",
              "MPIBWA_PALLAS", "MPIBWA_EXT"):
        env.pop(k, None)
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=str(fasta),
                         env=env, capture_output=True, text=True, timeout=600)
    return fasta, res


def test_cli_runs_without_jax_or_the_jax_package(standalone_run):
    """index, idx, mem (whole and as two shards), membychr, merge and
    mergebychr in one process that ends with neither jax nor mpibwa_tpu in
    sys.modules."""
    _, res = standalone_run
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("standalone ok")


def _no_pg(sam: bytes) -> bytes:
    """A SAM without its @PG line (it quotes the -o argument)."""
    return b"".join(ln for ln in sam.splitlines(True)
                    if not ln.startswith(b"@PG"))


def test_sharded_mem_merges_to_the_whole_run(standalone_run):
    d, res = standalone_run
    assert res.returncode == 0, res.stderr[-4000:]
    whole = _no_pg((d / "whole.sam").read_bytes())
    assert _no_pg((d / "merged.sam").read_bytes()) == whole
    assert whole.count(b"\n") > 240
    # both shards did work: the chunk size cut the input into several chunks
    assert (d / "part1.sam").stat().st_size > 0


def test_sharded_membychr_merges_to_the_whole_run(standalone_run):
    d, res = standalone_run
    assert res.returncode == 0, res.stderr[-4000:]
    names = sorted(os.listdir(d / "bychr_whole"))
    assert len(names) >= 3
    for n in names:
        assert _no_pg((d / "bychr_merged" / n).read_bytes()) == \
            _no_pg((d / "bychr_whole" / n).read_bytes()), n


def test_launch_merges_to_the_whole_run(standalone_run):
    """`launch -n 2 --hosts localhost,localhost mem` writes the whole run's
    SAM and removes its shard files; `-n 1` runs in the process; --keep
    keeps the shard files."""
    d, res = standalone_run
    assert res.returncode == 0, res.stderr[-4000:]
    whole = _no_pg((d / "whole.sam").read_bytes())
    for name in ("launched.sam", "launched1.sam", "kept.sam"):
        assert _no_pg((d / name).read_bytes()) == whole, name
    for k in (0, 1):
        assert not (d / f"launched.shard{k}.sam").exists()
        assert not (d / f"launched.shard{k}.sam.manifest.json").exists()
        assert (d / f"kept.shard{k}.sam").stat().st_size > 0
        assert (d / f"kept.shard{k}.sam.manifest.json").exists()
    assert not (d / "launched1.shard0.sam").exists()


def test_launch_membychr_merges_to_the_whole_run(standalone_run):
    d, res = standalone_run
    assert res.returncode == 0, res.stderr[-4000:]
    names = sorted(os.listdir(d / "bychr_whole"))
    assert sorted(os.listdir(d / "bychr_launched")) == names
    for n in names:
        assert _no_pg((d / "bychr_launched" / n).read_bytes()) == \
            _no_pg((d / "bychr_whole" / n).read_bytes()), n
    assert not any((d / f"bychr_launched.shard{k}").exists() for k in (0, 1))


def test_index_files_equal_the_jax_package(standalone_run, tmp_path):
    """`mpibwa_tpu_torch.cli index` and `idx` write byte for byte what
    `mpibwa_tpu.cli index` and `idx` write."""
    from mpibwa_tpu import cli as jax_cli

    d, res = standalone_run
    assert res.returncode == 0, res.stderr[-4000:]
    ref = str(tmp_path / "toy.fa")
    toy.write_fasta(ref, toy.make_genome())
    assert jax_cli.main_index([ref]) == 0
    assert jax_cli.main_idx([ref]) == 0
    for ext in INDEX_EXTS + (".tpumap",):
        with open(ref + ext, "rb") as fh:
            assert (d / ("toy.fa" + ext)).read_bytes() == fh.read(), ext
