"""A new cell, configuration or metric is a new file: the generator and the
harness find it by name, with no other edit; BENCHMARK.json is current and
within the contract's limits."""

import json
import os
import re
import shutil
import subprocess
import sys

from portbench import gen_benchmark, harness

REPO = os.path.dirname(harness.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

DEMO_METRIC = '''"""Calls in the window (a demonstration)."""

NAME, UNIT, BETTER, SOURCE = "demo.calls", "calls", "higher", "host_clock"
LAYER = "policy optimizer (control/trainer)"
MOVES, WORKLOADS = "lane_steps_per_s", ["cartpole.tiny"]


def read(ctx):
    return float(ctx["calls"])
'''

RUN = """
import json, sys, time
sys.path[:0] = [{copy!r}, {repo!r}]
import portbench, torch
assert portbench.__file__.startswith({copy!r}), portbench.__file__
torch.set_num_threads(2)
from portbench import harness
from portbench.tests import tiny
rc = harness.run_cell("cartpole.tiny", 2147483999, 0.2, True, "cpu", time.perf_counter(),
                      sizes=tiny.sizes("cartpole.tiny"))
sys.exit(rc)
"""


def test_benchmark_json_is_current():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        assert f.read() == gen_benchmark.render(gen_benchmark.benchmark())


def test_new_files_are_found_with_no_other_edit(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(harness.ROOT, copy, ignore=shutil.ignore_patterns("__pycache__"))
    cell = json.loads((copy / "workloads" / "cartpole.opt.json").read_text())
    cell.update(name="cartpole.tiny", traffic="tiny", rank=99)
    (copy / "workloads" / "cartpole.tiny.json").write_text(json.dumps(cell))
    (copy / "metrics" / "demo.calls.py").write_text(DEMO_METRIC)
    bench = gen_benchmark.benchmark(str(copy))
    assert bench["workloads"][-1]["name"] == "cartpole.tiny"
    assert {"name": "demo.calls", "unit": "calls", "better": "higher", "source": "host_clock",
            "layer": "policy optimizer (control/trainer)", "moves": "lane_steps_per_s",
            "workloads": ["cartpole.tiny"]} in bench["per_layer"]
    proc = subprocess.run([sys.executable, "-c", RUN.format(copy=str(tmp_path), repo=REPO)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metrics"]["demo.calls"]["value"] >= 1
    assert line["correct"] is True


NEW_CONFIG_RUN = """
import json, sys, time
sys.path[:0] = [{copy!r}, {repo!r}]
import portbench, torch
assert portbench.__file__.startswith({copy!r}), portbench.__file__
torch.set_num_threads(2)
from portbench import harness
from portbench.tests import tiny
from portbench.work import flops
cell, cfg = harness.load_cell("cartpole_b.tiny")
print("flops", flops.lane_step_flops(cfg, 384))
rc = harness.run_cell("cartpole_b.tiny", 2147483998, 0.2, False, "cpu", time.perf_counter(),
                      sizes=tiny.sizes("cartpole_b.tiny"))
sys.exit(rc)
"""


def test_new_configuration_is_new_files_only(tmp_path):
    # a configuration with a plant, a FLOP count and a model module of its
    # own (copies of the cart-pole's under new names), and a cell on it
    copy = tmp_path / "portbench"
    shutil.copytree(harness.ROOT, copy, ignore=shutil.ignore_patterns("__pycache__"))
    module = (copy / "reference" / "cartpole.py").read_text()
    module += ("\n\ndef cart_b(x, u):\n    return cartpole(x, u)\n"
               "\n\ndef flops_b(**kw):\n    return 2 * se_gram(**kw)\n")
    (copy / "reference" / "cartpole_b.py").write_text(module)
    cfg = json.loads((copy / "configs" / "cartpole.json").read_text())
    cfg.update(name="cartpole_b", reference="cartpole_b", flops="flops_b")
    cfg["data"]["ode"] = "cart_b"
    (copy / "configs" / "cartpole_b.json").write_text(json.dumps(cfg))
    cell = json.loads((copy / "workloads" / "cartpole.opt.json").read_text())
    cell.update(name="cartpole_b.tiny", config="cartpole_b", traffic="tiny", rank=99)
    (copy / "workloads" / "cartpole_b.tiny.json").write_text(json.dumps(cell))
    bench = gen_benchmark.benchmark(str(copy))
    assert [c["name"] for c in bench["configs"]] == ["cartpole", "cartpole_b", "furuta"]
    assert bench["workloads"][-1]["config"] == "cartpole_b"
    proc = subprocess.run([sys.executable, "-c",
                           NEW_CONFIG_RUN.format(copy=str(tmp_path), repo=REPO)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()
    assert out[0] == f"flops {2 * 44_601_120_000}"
    assert json.loads(out[-1])["correct"] is True


def test_benchmark_json_within_the_contract():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        text = f.read()
    b = json.loads(text)
    assert len(text.encode()) <= 64 * 1024
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert os.path.isfile(os.path.join(REPO, c["file"])) and c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert all(k in cfg for k in c["reduced"])
        names.add(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == \
        len(b["end_to_end"]) + len(b["per_layer"])
    for w in cells:  # every cell reports a per-layer metric
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])
