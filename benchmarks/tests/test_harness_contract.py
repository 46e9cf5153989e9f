"""The run contract: imports, the result line on every failure, and the
characters and structure of BENCHMARK.json."""

import ast
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import pytest
import torch

from benchmarks import outcome, run, spec

ROOT = spec.ROOT
BENCH = os.path.join(ROOT, "benchmarks")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(folder: str):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere_under_benchmarks():
    for path in _sources(BENCH):
        found = _imports(path) & set(run.FORBIDDEN)
        assert not found, (path, found)
    # whole top-level names: the port's name begins with the JAX package's
    assert "chess_vision_tpu_torch".split(".")[0] not in run.FORBIDDEN


def test_references_import_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH, "reference")):
        assert _imports(path) <= {"__future__", "contextlib", "itertools",
                                  "math", "torch", "benchmarks"}, path


def _fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "fake card")


def _last_json(text: str) -> dict:
    line = text.strip().splitlines()[-1]
    out = json.loads(line)
    # the five keys, a traced run's breakdown, and last each number compared
    # beside its limit
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) in (keys + ["checks"], keys + ["breakdown", "checks"])
    return out


ARGS = ["--workload", "vit_b16.serve_bf16", "--seed", "3000000000",
        "--seconds", "1", "--trace", "0"]


def test_exception_prints_the_line(monkeypatch, capsys):
    _fake_card(monkeypatch)

    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(run, "run_cell", boom)
    assert run.main(ARGS) == 1
    out = _last_json(capsys.readouterr().out)
    assert out["correct"] is False and "planted" in out["checks"]["error"]["value"]


def test_jax_loaded_prints_no_result(monkeypatch, capsys):
    _fake_card(monkeypatch)
    fake = outcome.Outcome(1, 0, {"boards_per_s": 1.0, "request_p95_ms": 1.0,
                                  "setup_s": 1.0}, {"gap_units": 0.0}, 0, 1, 1.0)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: (fake, True, {}))
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.main(ARGS) == run.JAX_LOADED
    assert capsys.readouterr().out.strip() == ""


def test_no_card_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "benchmarks.run", *ARGS],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == run.NO_DEVICE
    assert proc.stdout.strip() == ""


_DRIVER = """
import sys, time, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.get_device_name = lambda i=0: "fake card"
from benchmarks import run
if sys.argv[1] == "sleep":
    def slow(*a, **k):
        print("started", file=sys.stderr, flush=True)
        time.sleep(60)
    run.run_cell = slow
sys.exit(run.main(sys.argv[2:]))
"""


def test_sigterm_prints_the_line():
    proc = subprocess.Popen([sys.executable, "-c", _DRIVER, "sleep", *ARGS],
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stderr:
            if "started" in line:
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 1
    assert _last_json(out)["correct"] is False


def test_without_the_program_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-c", _DRIVER, "run", *ARGS],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == run.NO_PROGRAM, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""


def _bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in b[group]:
            names.append(entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    assert len(set(names)) == len(names)
    assert 1 <= b["run_seconds"] <= 51


def test_every_cell_reports_what_it_must():
    b = _bench()
    for w in b["workloads"]:
        cell = spec.load(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert spec.metric_reader(m["name"]).UNIT == m["unit"]
        assert cell.limits and cell.control, w["name"]
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_new_traffic_and_metric_files_are_found(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    b["workloads"].append({"name": "vit_b16.dummy", "config": "vit_b16",
                           "traffic": "dummy", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "dummy_count", "unit": "boards",
                           "better": "higher", "source": "program_counter",
                           "layer": "serve", "moves": "boards_per_s",
                           "workloads": ["vit_b16.dummy"]})
    b["end_to_end"][0]["workloads"].append("vit_b16.dummy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = json.loads((tmp_path / "benchmarks/traffic/serve_bf16.json").read_text())
    traffic["request_boards"] = 256
    (tmp_path / "benchmarks/traffic/dummy.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmarks/metrics/dummy_count.py").write_text(
        'UNIT = "boards"\n\n\ndef read(ctx):\n    return ctx["items"]\n')
    cell = spec.load("vit_b16.dummy", root=str(tmp_path))
    assert cell.traffic["request_boards"] == 256
    assert [m["name"] for m in cell.per_layer] == ["dummy_count"]
    reader = spec.metric_reader("dummy_count", root=str(tmp_path))
    assert reader.read({"items": 512}) == 512
    assert {m["name"] for m in cell.end_to_end} == {"boards_per_s", "setup_s"}


def test_new_training_cell_on_another_config_runs(tmp_path):
    """A training cell on the CNN, added as an entry and a limits file alone,
    runs to its verdict on the CPU at a toy size: the driver knows no
    architecture's parameter names."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    name = "convnextv2_tiny.train_bf16"
    b["workloads"].append({"name": name, "config": "convnextv2_tiny",
                           "traffic": "train_bf16", "chips": 1, "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "vit_b16.train_bf16" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    limits = tmp_path / "benchmarks/limits"
    shutil.copy(limits / "vit_b16.train_bf16.json", limits / f"{name}.json")
    cell = spec.load(name, root=str(tmp_path)).with_overrides(
        {"model": {"input_size": 128}}, {"corpus_boards": 64, "batch_size": 8})
    assert {m["name"] for m in cell.end_to_end} == {"train_img_per_s", "setup_s"}
    _, correct, checks = run.run_cell(cell, 3_000_000_007, 0.3, False,
                                      torch.device("cpu"), time.perf_counter())
    assert correct, checks


@pytest.mark.parametrize("breakdown", [None, {"device_ops": [], "idle_gaps": []}])
def test_result_line_keys(breakdown):
    checks = {"gap_units": {"value": 1.0, "limit": 2.0}}
    line = json.loads(run.result_line(True, 2, 0, {}, {"platform": "gpu"},
                                      checks, breakdown))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if breakdown else []) + ["checks"]
    assert line["checks"] == checks
