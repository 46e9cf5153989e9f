"""What a run reads: ``BENCHMARK.json`` at the root of the checkout and the
files it names by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's file is ``BENCHMARK.json``'s ``configs[].file``
(``benchmarks/configs/<name>.json``), which names its reference module
(``benchmarks/reference/<reference>.py``); the traffic mix is
``benchmarks/traffic/<traffic>.json``; the limits of the cell's correctness
check are ``benchmarks/limits/<cell>.json``; a per-layer metric's reader is
``benchmarks/metrics/<metric>.py``. Adding any of them is adding a file and
an entry; no code here knows a cell by its name.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys laid over it, nested dicts merged."""
    out = copy.deepcopy(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    limits: dict          # the correctness limits, by number compared
    control: dict         # the control the limits were set against
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]

    def reference(self):
        return importlib.import_module(
            f"benchmarks.reference.{self.config['reference']}")

    def with_overrides(self, config: dict | None = None,
                       traffic: dict | None = None) -> "Cell":
        """A copy with keys laid over the configuration and the traffic
        (the CPU tests run cells at toy sizes)."""
        return dataclasses.replace(
            self, config=merge(self.config, config or {}),
            traffic=merge(self.traffic, traffic or {}))


def _reports(metric: dict, cell: str, e2e: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, else every
    cell that reports the end-to-end metric it moves (an end-to-end metric
    without a list: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e


def load(name: str, root: str = ROOT) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "benchmarks", "traffic",
                                      f"{w['traffic']}.json"))
    limits_path = os.path.join(root, "benchmarks", "limits", f"{name}.json")
    checked = _load_json(limits_path) if os.path.exists(limits_path) else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name, int(w["chips"]), config, traffic,
                checked.get("limits", {}), checked.get("control", {}), e2e,
                per_layer)


def metric_reader(name: str, root: str = ROOT):
    """The module ``benchmarks/metrics/<name>.py``: ``UNIT`` and
    ``read(ctx)``, which returns a number or None."""
    path = os.path.join(root, "benchmarks", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmarks_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
