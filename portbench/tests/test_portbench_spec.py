"""BENCHMARK.json against the benchmark's rules, what the benchmark
imports, and files found by name."""

import ast
import json
import os
import re
import shutil

import pytest

from harness import spec

BENCH = spec.BENCH
ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX = {"jax", "jaxlib", "flax", "mpibwa_tpu"}
PLAIN = ("harness/genome.py", "harness/simulate.py", "harness/reference.py",
         "harness/window.py", "harness/trace.py", "harness/spec.py",
         "generators", "checks")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_names_units_and_entries_keep_to_the_rules():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        tr = json.load(open(os.path.join(BENCH, "traffic",
                                         w["traffic"] + ".json")))
        for kind in ("generator", "check"):  # found by name
            assert os.path.exists(os.path.join(
                BENCH, kind + "s", tr.get(kind, "pairs") + ".py"))
        names += [w["name"], w["traffic"]]
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= set(cells)
        names.append(m["name"])
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        # each cell it is read in reports the metric it moves
        assert set(m.get("workloads", cells)) <= set(e2e[m["moves"]])
        assert m["layer"] and "\n" not in m["layer"]
    for c in cells:  # setup_s, another end-to-end metric, a per-layer one
        assert sum(c in w for w in e2e.values()) >= 2
        assert any(c in m.get("workloads", cells) for m in b["per_layer"])
    assert all(NAME.match(n) for n in names)
    for entry in b["configs"] + b["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\t" not in entry["why"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _relative(path):
    """What a module imports from the harness package: from . import x in
    it, from harness import x outside it."""
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.ImportFrom) and node.level:
            yield from ([node.module] if node.module else
                        [a.name for a in node.names])
        elif isinstance(node, ast.ImportFrom) and node.module == "harness":
            yield from (a.name for a in node.names)


def _py_files():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _py_files():
        assert not set(_imports(path)) & JAX, path


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    paths = []
    for f in PLAIN:
        path = os.path.join(BENCH, f)
        paths += ([os.path.join(path, g) for g in sorted(os.listdir(path))
                   if g.endswith(".py")] if os.path.isdir(path) else [path])
    assert len(paths) >= len(PLAIN) + 2
    for path in paths:
        assert "mpibwa_tpu_torch" not in set(_imports(path)), path
        assert not {"program", "cell"} & set(_relative(path)), path


def test_a_new_config_mix_cell_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    # what a later PR adds: files and entries, no edit of a file that is
    cfg = json.load(open(os.path.join(ROOT, b["configs"][0]["file"])))
    (bench / "configs" / "toy.json").write_text(
        json.dumps(dict(cfg, genome_length=1000)))
    (bench / "traffic" / "toy-mix.json").write_text(
        json.dumps({"read_len": 50, "limits": {}, "generator": "toy_gen",
                    "check": "toy_check"}))
    (bench / "generators" / "toy_gen.py").write_text("PAIRED = False\n")
    (bench / "checks" / "toy_check.py").write_text(
        "def check(*args):\n    return {}\n")
    (bench / "metrics" / "toy_metric.py").write_text(
        "def read(run):\n"
        "    return run.reads * 2.0 if run.cell == 'toy.cell' else None\n")
    (bench / "metrics" / "toy_silent.py").write_text(
        "def read(run):\n    return None\n")
    b["configs"].append({"name": "toy", "source": "x", "file":
                         "portbench/configs/toy.json", "reduced": [],
                         "why": "x"})
    b["workloads"].append({"name": "toy.cell", "config": "toy",
                           "traffic": "toy-mix", "chips": 1, "why": "x"})
    # the new cell reports reads_per_s, as the cells listed there do
    for m in b["end_to_end"]:
        if "workloads" in m and m["name"] == "reads_per_s":
            m["workloads"].append("toy.cell")
    b["per_layer"] += [
        {"name": "toy_metric", "unit": "x", "better": "lower",
         "source": "host_clock", "layer": "toy", "moves": "reads_per_s"},
        {"name": "toy_silent", "unit": "x", "better": "lower",
         "source": "host_clock", "layer": "toy", "moves": "reads_per_s"}]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("toy.cell", str(root), str(bench))
    assert cell.config["genome_length"] == 1000
    assert cell.traffic["read_len"] == 50
    assert not spec.mix_module(cell.traffic, "generator", str(bench)).PAIRED
    assert spec.mix_module(cell.traffic, "check", str(bench)).check() == {}
    # a mix that names neither takes the paired generator and check
    pe = spec.load_cell(b["workloads"][0]["name"], str(root), str(bench))
    assert spec.mix_module(pe.traffic, "generator", str(bench)).PAIRED
    names = [m["name"] for m in cell.per_layer]
    assert "toy_metric" in names and "toy_silent" in names

    class Run:
        reads = 21
        cell = "toy.cell"
    toys = [m for m in cell.per_layer if m["name"].startswith("toy")]
    got = spec.read_metrics(toys, Run(), str(bench))
    assert got == {"toy_metric": {"value": 42.0, "unit": "x"}}
    # a metric that does not apply to a cell finds nothing to read there
    Run.cell = b["workloads"][0]["name"]
    assert spec.read_metrics(toys, Run(), str(bench)) == {}


@pytest.mark.parametrize("cell, e2e, some_layers", [
    ("int32.pe101", ["device_peak_gib", "setup_s"], ["window_reads_per_s"]),
    ("int64.pe101", ["reads_per_s", "device_peak_gib", "setup_s"],
     ["parse_s_per_mread", "device_idle_share"]),
    ("int32.se101", ["device_peak_gib", "setup_s"], ["window_reads_per_s"])])
def test_each_cell_reports_the_metrics_that_list_it(cell, e2e, some_layers):
    c = spec.load_cell(cell)
    assert [m["name"] for m in c.end_to_end] == e2e
    layers = [m["name"] for m in c.per_layer]
    assert set(some_layers) <= set(layers)
    assert all(m["moves"] in e2e for m in c.per_layer)
    if cell.startswith("int32."):
        assert layers == ["window_reads_per_s"]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell")
