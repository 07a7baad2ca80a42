"""What a run measures, found by name: the cell in BENCHMARK.json, its
configuration (configs/<name>.json), its traffic mix (traffic/<name>.json)
and each metric's reader (metrics/<name>.py, a ``read(run)`` that returns
a number, or None when it finds nothing to read).

Adding a configuration, a mix, a cell or a metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = ROOT, bench: str = BENCH) -> Cell:
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfgs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = cfgs[w["config"]]
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    traffic = _load_json(os.path.join(bench, "traffic",
                                      w["traffic"] + ".json"))
    # the metrics that list this cell under "workloads", or list no cells;
    # a per-layer metric only where the end-to-end one it moves is
    def here(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if here(m) and m["moves"] in names]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                traffic, e2e, per_layer)


def reader(metric: str, bench: str = BENCH):
    """metrics/<metric>.py's read function."""
    path = os.path.join(bench, "metrics", metric + ".py")
    mod_name = "portbench_metric_" + metric.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def read_metrics(entries, run, bench: str = BENCH) -> dict:
    """{name: {"value", "unit"}} of the entries whose readers find a
    number in run."""
    out = {}
    for m in entries:
        v = reader(m["name"], bench)(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
