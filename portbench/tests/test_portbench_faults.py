"""The check catches the faults a training cell can have, planted in the
port underneath a run (CPU, tiny sizes), and its control, the reference in
TF32, fails it on the card."""

import pytest
import torch

from mcpilco_tpu_torch.control import trainer
from mcpilco_tpu_torch.control.trainer import PolicyOptimizer
from mcpilco_tpu_torch.models import costs as port_costs
from mcpilco_tpu_torch.models.gp import MultiGP
from portbench import harness
from portbench.tests import tiny


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state_unchanged(monkeypatch):
    # every gradient zero: Adam's step leaves the parameters as they were
    monkeypatch.setattr(PolicyOptimizer, "_masked_grads",
                        lambda self, grads, mask: {k: torch.zeros_like(g)
                                                   for k, g in grads.items()})


def _half_batch(monkeypatch):
    real = port_costs.expected_cost
    monkeypatch.setattr(port_costs, "expected_cost",
                        lambda stage, group=None: real(stage[..., : stage.shape[-1] // 2], group))


def _half_gradient(monkeypatch):
    # the cost over every particle, its gradient over half of them
    real = port_costs.expected_cost

    def half(stage, group=None):
        c, s = real(stage, group)
        h, _ = real(stage[..., : stage.shape[-1] // 2], group)
        return c.detach() + h - h.detach(), s
    monkeypatch.setattr(port_costs, "expected_cost", half)


def _later_iterations_skipped(monkeypatch):
    # after a call's first two iterations the body no longer runs, while
    # the step counter still advances: the window's calls count steps they
    # never ran (the warm-up call, two steps long, is whole)
    real, step = trainer._DeviceStep.__call__, trainer._INTS.index("step")

    def skip(self):
        self.ran = getattr(self, "ran", 0) + 1
        if self.ran <= 2:
            return real(self)
        cells = dict(zip(self.body.__code__.co_freevars, self.body.__closure__))
        buf = cells["buf"].cell_contents
        buf.ints[step] += 1
        return "uncaptured"
    monkeypatch.setattr(trainer._DeviceStep, "__call__", skip)


def _cost_altered(monkeypatch):
    real = port_costs.expected_cost

    def altered(stage, group=None):
        c, s = real(stage, group)
        return c * 1.1, s
    monkeypatch.setattr(port_costs, "expected_cost", altered)


def _prediction_altered(monkeypatch):
    real = MultiGP.predict

    def altered(self, params, post, x_star):
        mean, var = real(self, params, post, x_star)
        return mean * 1.1, var
    monkeypatch.setattr(MultiGP, "predict", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "half_gradient": _half_gradient, "later_iterations_skipped": _later_iterations_skipped,
          "cost_altered": _cost_altered, "prediction_altered": _prediction_altered}


# a gradient over half of the particles reads only on ``grad_gap``, which
# the single-lane cells do not compare: on the card their float32 gradients
# sit as far from float64 as that fault's on some seeds (PERF.md); the farm,
# which runs the same optimizer step, compares it
CASES = [(cell, fault) for cell in ("cartpole.opt", "furuta.opt", "cartpole.farm8")
         for fault in sorted(FAULTS)
         if fault != "half_gradient" or "grad_gap" in harness.load_cell(cell)[0]["limits"]]


def test_half_gradient_is_compared_in_some_cell():
    assert ("cartpole.farm8", "half_gradient") in CASES


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_in_the_port_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    rc, line, _ = tiny.run(cell)
    assert rc == 0
    assert line["correct"] is False and line["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in line["check"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cartpole.opt", "furuta.opt"])
def test_control_fails_the_check(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control runs TF32 matmuls, which only a CUDA card has")
    from portbench import calibrate

    limits = harness.load_cell(cell)[0]["limits"]
    sizes = {"config": {"num_particles": 100}, "scenario": {"num_particles": 100}}
    for seed in (2147483601, 2147483602, 2147483603):
        got = dict(calibrate.readings(cell, seed, ["control"], "cuda:0", sizes))["control"]
        assert any(got[k] > limits[k] for k in limits), (seed, got, limits)
