"""A whole run at the rehearsal's tiny sizes: the program passes the
check; the control and each fault the cell can have fail it; a run with
no card, or with no program beside the benchmark, prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import cell as C
from harness import program
from harness.spec import BENCH, ROOT, load_cell

CELL = "int32.pe101"
SECONDS = 2.0


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MPIBWA_TORCH_DEVICE", "cpu")


def _run(seed, options=None, device=None, cell=CELL):
    out, lines = C.measure(load_cell(cell), seed, SECONDS, False, True, 0.0,
                           options=options, device=device)
    assert out is not None, lines
    return out


def _checks(out):
    return {k: c["value"] for k, c in out["checks"].items()}


@pytest.mark.parametrize("cell", ["int32.pe101", "int64.pe101",
                                  "int32.se101"])
def test_the_program_passes_and_loads_no_jax(cell):
    out = _run(2**31 + 5, cell=cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"] == {} and "device" not in out
    assert list(out)[-1] == "checks"
    assert C.loaded_jax() == []


def _control(device, cell=CELL):
    out = _run(2**31 + 6, options={"w": 0}, device=device, cell=cell)
    assert not out["correct"]
    got = _checks(out)
    assert got["score_miss_pct"] > out["checks"]["score_miss_pct"]["limit"]


@pytest.mark.parametrize("cell", ["int32.pe101", "int32.se101"])
def test_the_control_fails(cell):
    _control(None, cell)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["int32.pe101", "int32.se101"])
def test_the_control_fails_on_the_card(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    _control(torch.device("cuda", 0), cell)


def _faulty(kind):
    real = program.run_chunk
    state = {}

    def run_chunk(al, plan, ci, clock, *rest):
        records, parse = real(al, plan, ci, clock, *rest)
        if kind == "half":  # half of the batch left out
            records = records[: len(records) // 2]
        elif kind == "dropped":  # one read's record left out
            del records[len(records) // 2]
        elif kind == "stale":  # the step returns its last state unchanged
            records, state["last"] = state.get("last", records), records
        elif kind == "altered":  # every 7th answer's POS moved by one
            for i in range(0, len(records), 7):
                f = records[i].split(b"\t")
                if f[3] != b"0":
                    f[3] = str(int(f[3]) + 1).encode()
                records[i] = b"\t".join(f)
        return records, parse
    return run_chunk


@pytest.mark.parametrize("cell,kind,number", [
    ("int32.pe101", "half", "missing_records"),
    ("int32.pe101", "stale", "missing_records"),
    ("int32.pe101", "altered", "bad_alignment"),
    ("int32.se101", "half", "missing_records"),
    ("int32.se101", "stale", "missing_records"),
    ("int32.se101", "dropped", "missing_records"),
    ("int32.se101", "altered", "bad_alignment")])
def test_each_fault_fails(monkeypatch, cell, kind, number):
    monkeypatch.setattr(program, "run_chunk", _faulty(kind))
    out = _run(2**31 + 7, cell=cell)
    assert not out["correct"]
    assert _checks(out)[number] > 0


def _cli(cwd, *args):
    env = dict(os.environ)
    env.pop("MPIBWA_TORCH_DEVICE", None)
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           CELL, "--seed", "3", "--seconds", "1", *args],
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=600)


def test_a_measured_run_without_a_card_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    r = _cli(ROOT)
    assert r.returncode != 0 and r.stdout == ""


def test_the_benchmark_alone_prints_nothing(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(str(tmp_path), "--rehearse")
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    with pytest.raises(json.JSONDecodeError):
        json.loads(r.stdout.strip().splitlines()[-1] if r.stdout.strip()
                   else "")
