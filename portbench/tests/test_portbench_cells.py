"""Each cell at a tiny size on the CPU prints the contract's result line."""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CELLS = [w["name"] for w in __import__("json").load(open(
    __import__("os").path.join(harness.ROOT, "..", "BENCHMARK.json")))["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_the_contract_line(cell, trace):
    rc, line, err = tiny.run(cell, trace=bool(trace))
    assert rc == 0
    assert list(line)[:5] == KEYS
    assert list(line)[-1] == "check" and set(line) <= set(KEYS) | {"breakdown", "check"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    if trace:
        # off the card no device metric is read
        assert not {"device.idle_share", "k1_roofline", "step_mfu"} & set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"lane_steps_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    limits = harness.load_cell(cell)[0]["limits"]
    assert set(line["check"]) == set(limits)
    checked = [e for e in err if e.startswith("check ")]
    assert err[-len(limits):] == checked and len(checked) == len(limits)
    for k, v in line["check"].items():
        assert v["limit"] == limits[k] and 0 <= v["value"] <= v["limit"]


def test_seed_gives_the_same_inputs():
    from portbench import inputs

    _, cfg = harness.load_cell("cartpole.opt")
    a, b = inputs.lane_inputs(cfg, 2**31 + 7, 0), inputs.lane_inputs(cfg, 2**31 + 7, 0)
    c = inputs.lane_inputs(cfg, 2**31 + 8, 0)
    assert (a["measured"] == b["measured"]).all() and (a["policy"]["centers"]
                                                      == b["policy"]["centers"]).all()
    assert not (a["measured"] == c["measured"]).all()
    assert a["measured"].shape == (6, 61, 4) and a["policy"]["centers"].shape == (200, 5)
