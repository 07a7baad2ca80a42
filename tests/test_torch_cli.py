"""End to end: `mpibwa_tpu_torch.cli mem` writes the same bytes as
`mpibwa_tpu.cli mem` on the toy genome (SE, PE, both MPIBWA_EXT values,
fixmate, BGZF, BAM, trimmed PE, -t 2, CRLF input, by-chromosome output
and the backward-overflow route),
with the port on the CPU. Also: the port never imports jax, and asking
for CUDA without a card raises."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401

torch.set_num_threads(1)  # test workers run in parallel on few cores


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PAIRS = 300


def _head(src: str, dst: str, n: int) -> str:
    with open(src) as f, open(dst, "w") as g:
        for i, line in enumerate(f):
            if i >= 4 * n:
                break
            g.write(line)
    return dst


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("toy")
    paths = toy.build_toy(str(d))
    return {"ref": paths["ref"],
            "r1": _head(paths["r1"], str(d / "a1.fq"), N_PAIRS),
            "r2": _head(paths["r2"], str(d / "a2.fq"), N_PAIRS),
            "o1": _head(paths["r1"], str(d / "o1.fq"), 64),
            "o2": _head(paths["r2"], str(d / "o2.fq"), 64),
            "trim2": _trimmed(str(d / "o2.fq"), str(d / "trim2.fq")),
            "crlf1": _crlf(str(d / "o1.fq"), str(d / "crlf1.fq")),
            "crlf2": _crlf(str(d / "o2.fq"), str(d / "crlf2.fq"))}


def _crlf(src: str, dst: str) -> str:
    """src with CRLF line ends."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        g.write(f.read().replace(b"\n", b"\r\n"))
    return dst


def _trimmed(src: str, dst: str) -> str:
    """src with each read cut to a seeded length of 60-101 bp (the files'
    sizes then differ: the runtime's trimmed-PE chunking)."""
    rng = np.random.default_rng(5)
    lines = open(src).read().splitlines()
    with open(dst, "w") as g:
        for i in range(0, len(lines), 4):
            n = int(rng.integers(60, 102))
            g.write(f"{lines[i]}\n{lines[i + 1][:n]}\n+\n"
                    f"{lines[i + 3][:n]}\n")
    return dst


def _outputs(path):
    """{relative name: bytes} of an output file or directory."""
    if os.path.isdir(path):
        return {n: open(os.path.join(path, n), "rb").read()
                for n in sorted(os.listdir(path))}
    return {os.path.basename(path): open(path, "rb").read()}


def _run_both(tmp_path, monkeypatch, args, out, by_chr=False):
    """Run both CLIs in this process with the same arguments (relative -o,
    so the @PG command lines match); returns (jax outputs, port outputs)."""
    from mpibwa_tpu import cli as jax_cli
    from mpibwa_tpu_torch import cli as torch_cli

    monkeypatch.setenv("MPIBWA_TORCH_DEVICE", "cpu")
    got = {}
    for name, run in (
            ("jax", lambda a: jax_cli.main_mem(a, by_chr=by_chr)),
            ("torch", lambda a: torch_cli.main(
                ["membychr" if by_chr else "mem"] + a))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert run(["-o", "out"] + args) == 0, name
        got[name] = _outputs(str(d / out))
    return got["jax"], got["torch"]


@pytest.mark.parametrize("ext", ["device", "native"])
@pytest.mark.parametrize("pe", [True, False], ids=["pe", "se"])
def test_mem_sam_identical(data, tmp_path, monkeypatch, ext, pe):
    monkeypatch.setenv("MPIBWA_EXT", ext)
    args = ["-t", "1", data["ref"], data["r1"]] + ([data["r2"]] if pe else [])
    want, got = _run_both(tmp_path, monkeypatch, args, "out.sam")
    assert got == want
    assert got["out.sam"].count(b"\n") > N_PAIRS


@pytest.mark.parametrize("flag,out", [("-f", "out.sam"), ("-g", "out.gz")],
                         ids=["fixmate", "bgzf"])
def test_mem_output_flags_identical(data, tmp_path, monkeypatch, flag, out):
    monkeypatch.setenv("MPIBWA_EXT", "device")
    args = [flag, "-t", "1", data["ref"], data["r1"], data["r2"]]
    want, got = _run_both(tmp_path, monkeypatch, args, out)
    assert got == want


@pytest.mark.parametrize("case", ["trimmed_pe", "bam", "t2", "crlf"])
def test_more_flags_identical(data, tmp_path, monkeypatch, case):
    """Trimmed PE (R2 cut, several chunks), BAM output (-b), two workers
    (-t 2, which also sets the default -K) and CRLF input (several
    chunks) on both CLIs."""
    monkeypatch.delenv("MPIBWA_EXT", raising=False)
    args, out = {
        "trimmed_pe": (["-t", "1", "-K", "4000", data["ref"], data["o1"],
                        data["trim2"]], "out.sam"),
        "bam": (["-b", "-t", "1", data["ref"], data["o1"], data["o2"]],
                "out.bam"),
        "t2": (["-t", "2", data["ref"], data["o1"], data["o2"]], "out.sam"),
        "crlf": (["-t", "1", "-K", "4000", data["ref"], data["crlf1"],
                  data["crlf2"]], "out.sam"),
    }[case]
    want, got = _run_both(tmp_path, monkeypatch, args, out)
    assert got == want
    assert len(got[out]) > 1000


def test_membychr_identical(data, tmp_path, monkeypatch):
    monkeypatch.setenv("MPIBWA_EXT", "device")
    args = ["-t", "1", data["ref"], data["r1"], data["r2"]]
    want, got = _run_both(tmp_path, monkeypatch, args, "out", by_chr=True)
    assert got == want
    assert len(got) >= 3  # chrA, chrB, discordant/unmapped


def test_overflow_route_identical(data, tmp_path, monkeypatch):
    """M_CAP shrunk to 2 in both packages: collect_flat overflows, every
    microbatch takes the list route (collect_batch, Python chaining with
    the device extension of _precompute_extensions, C finalization)."""
    from mpibwa_tpu.ops import seeding_flat as JSF
    from mpibwa_tpu_torch.ops import seeding_flat as TSF
    from mpibwa_tpu_torch.pipeline.device_align import DeviceAligner

    monkeypatch.setattr(JSF, "M_CAP", 2)
    monkeypatch.setattr(TSF, "M_CAP", 2)
    monkeypatch.setenv("MPIBWA_EXT", "device")
    calls = []
    inner = DeviceAligner._precompute_extensions

    def spy(self, *a, **k):
        calls.append(len(a[0]))
        return inner(self, *a, **k)

    monkeypatch.setattr(DeviceAligner, "_precompute_extensions", spy)
    args = ["-t", "1", data["ref"], data["o1"], data["o2"]]
    want, got = _run_both(tmp_path, monkeypatch, args, "out.sam")
    assert got == want
    assert calls  # the port took the list route


def _python(code: str, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import mpibwa_tpu_torch, mpibwa_tpu_torch.cli\n"
            "import mpibwa_tpu_torch.parallel.runtime\n"
            "import mpibwa_tpu_torch.pipeline.device_align\n"
            "import mpibwa_tpu_torch.ops.extend_cuda\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "print('ok')\n")
    res = _python(code, dict(os.environ))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cuda_without_a_card_raises(data, tmp_path):
    """No silent CPU fallback: the CLI asks for cuda by default and fails
    when no GPU is visible."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("MPIBWA_TORCH_DEVICE", None)
    code = ("import sys\n"
            "from mpibwa_tpu_torch.cli import main\n"
            f"main(['mem', '-o', {str(tmp_path / 'x')!r}, {data['ref']!r}, "
            f"{data['o1']!r}])\n")
    res = _python(code, env)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
