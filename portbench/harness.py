"""One run of a cell: set-up, warm-up, the measured window, the traced
sub-window, the check against the plain reference, and the result line.

The system under test is ``mcpilco_tpu_torch``: ``PolicyOptimizer.optimize``
for a single lane, ``SeedFarm.improve_policy`` for a farm of seeds as lanes.
Set-up hands the port the inputs made from the seed (``inputs.py``):
each lane's trials, GP hyperparameters and initial policy; the port builds
its posterior from them (its SOD selection where the configuration has
one).  The first call of the window's own kind, ``check_steps`` steps long,
is the warm-up: it loads every kernel and captures the step's graph once.
The window then runs calls of ``steps_per_call`` steps back to back, each
continuing from the last call's policy, until the next call would end more
than ``SLACK_S`` past the window.  The reference judges the warm-up call,
with each step's gradient read from the optimizer's Adam moments
(``readout``), and the window's last call (``check.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np
import torch

from . import check
from . import inputs as inp
from . import trace as tr
from .reference import common as ref

ROOT = os.path.dirname(os.path.abspath(__file__))
# a call starts only where the last one's length says it ends by then
SLACK_S = 2.0
# the key tag of a single lane's calls: call c of seed s is keyed (s, CALL_TAG, c)
CALL_TAG = 0xBE
FORBIDDEN = ("jax", "jaxlib", "flax", "mcpilco_tpu")


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def load_cell(name: str):
    cell = load_json("workloads", f"{name}.json")
    return cell, load_json("configs", f"{cell['config']}.json")


def forbidden_modules():
    """The modules of the JAX package or of JAX loaded in this process,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tree(t, device):
    if isinstance(t, dict):
        return {k: _tree(v, device) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return tuple(_tree(v, device) for v in t)
    return torch.as_tensor(np.ascontiguousarray(t), device=device)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(_stack(list(x)) for x in zip(*trees))
    return np.stack(trees)


@dataclasses.dataclass
class Run:
    """What a run carries from set-up to the result line."""

    cell: dict
    cfg: dict
    seed: int
    device: torch.device
    lanes: list  # each lane's inputs (inputs.lane_inputs)
    system: object = None
    info: dict = dataclasses.field(default_factory=dict)


def scenario(cfg: dict, device, sizes: dict):
    """The port's agent for ``cfg``, built by its scenario module
    (``sizes`` overrides the scenario config's fields, for tests at a tiny
    size)."""
    scen = importlib.import_module(f"mcpilco_tpu_torch.scenarios.{cfg['scenario']}")
    klass = getattr(scen, cfg["scenario_class"])
    fields = {f.name for f in dataclasses.fields(klass)}
    kw = dict(cfg["scenario_kwargs"])
    kw.update({k: v for k, v in sizes.items() if k in fields})
    sc = klass(**kw)
    agent, _ = scen.build(sc, device)
    return agent


class Single:
    """One lane: ``PolicyOptimizer.optimize`` on the agent's posterior."""

    def __init__(self, run: Run, agent):
        from mcpilco_tpu_torch.models.gp import GPParams

        lane = run.lanes[0]
        for m, u in zip(lane["measured"], lane["inputs"]):
            agent.add_external_trial(m, u)
        agent.gp_params = GPParams(kernel=_tree(lane["kernel"], run.device),
                                   log_sigma_n=_tree(lane["log_sigma_n"], run.device))
        info = {}
        agent.posterior = agent._build_posterior(agent._padded_data(), info)
        agent.policy_params = _tree(lane["policy"], run.device)
        run.info.update(M=int(agent.posterior.x_tr.shape[-2]),
                        jitter_scale=[float(info.get("jitter_scale", 1.0))],
                        sod_points=[info.get("sod_points")])
        self.agent, self.seed, self.cfg = agent, run.seed, run.cfg

    def keys(self, index: int):
        """Each lane's key of call ``index``."""
        return [(self.seed, CALL_TAG, index)]

    def params(self):
        return [{k: v.detach().cpu().numpy() for k, v in self.agent.policy_params.items()}]

    def call(self, index: int, steps: int):
        """One call: (lane-steps done, per lane its costs, steps done and
        last rollout)."""
        a = self.agent
        res = a.optimizer.optimize(self.keys(index)[0], a.policy_params, a.gp_params,
                                   a.posterior, steps, self.cfg["learning_rate"],
                                   self.cfg["p_dropout"], trial_index=0)
        a.policy_params = res.policy_params
        return res.steps_done, [dict(costs=res.cost_history.numpy()[:steps],
                                     steps_done=res.steps_done, states=res.states,
                                     inputs=res.inputs)]

    def close(self):
        self.agent = None


class Farm:
    """A farm of seeds as lanes: ``SeedFarm.improve_policy``, each lane
    with its own trials, hyperparameters, posterior and policy."""

    def __init__(self, run: Run, agent):
        from mcpilco_tpu_torch.control.mc_pilco import PolicyOptOptions
        from mcpilco_tpu_torch.models.gp import GPParams
        from mcpilco_tpu_torch.parallel.multiseed import SeedFarm

        L = len(run.lanes)
        self.seeds = [run.seed * L + i for i in range(L)]
        policies = {(s,): _tree(lane["policy"], run.device)
                    for s, lane in zip(self.seeds, run.lanes)}
        farm = SeedFarm(agent, seeds=self.seeds, policy_init_fn=lambda k: policies[tuple(k)])
        xs, ys = [], []
        for lane in run.lanes:
            pairs = [agent.model.training_pairs(torch.as_tensor(m), torch.as_tensor(u))
                     for m, u in zip(lane["measured"], lane["inputs"])]
            xs.append(np.concatenate([x.numpy() for x, _ in pairs]))
            ys.append(np.concatenate([y.numpy() for _, y in pairs], axis=1))
        farm.gp_x, farm.gp_y = np.stack(xs), np.stack(ys)
        farm.num_collections = len(run.lanes[0]["measured"])
        farm.gp_params = GPParams(
            kernel=_tree(_stack([lane["kernel"] for lane in run.lanes]), run.device),
            log_sigma_n=_tree(np.stack([lane["log_sigma_n"] for lane in run.lanes]), run.device))
        farm.posterior, scale = farm._build_posterior(farm._padded_data())
        run.info.update(M=int(farm.posterior.x_tr.shape[-2]),
                        jitter_scale=[float(s) for s in scale])
        self.farm, self.opts = farm, PolicyOptOptions
        self.cfg = run.cfg

    def keys(self, index: int):
        return [(s, ref.STREAM_ROLLOUT, index) for s in self.seeds]

    def params(self):
        p = self.farm.policy_params
        return [{k: v[i].detach().cpu().numpy() for k, v in p.items()}
                for i in range(len(self.seeds))]

    def call(self, index: int, steps: int):
        costs, done, _ = self.farm.improve_policy(
            self.opts(opt_steps=steps, learning_rate=self.cfg["learning_rate"],
                      p_dropout=self.cfg["p_dropout"]), trial_index=index)
        info = self.farm.opt_info
        return int(np.sum(done)), [dict(costs=c[:steps], steps_done=int(d), states=s, inputs=u)
                                   for c, d, s, u in zip(costs, done, info["states"],
                                                         info["inputs"])]

    def close(self):
        self.farm = None


SYSTEMS = {"single": Single, "farm": Farm}


@contextlib.contextmanager
def readout(steps: list):
    """Within it, every optimizer call keeps, after each iteration, a copy
    of its Adam first moments, parameters and last rollout in ``steps`` (a
    dict per iteration, each leaf with the lane axis in front): the state
    the check reads each step's gradient from.  It wraps the trainer's
    buffer constructor and device step, and changes nothing they compute."""
    from mcpilco_tpu_torch.control import trainer

    new, call = trainer._Static.__dict__["new"], trainer._DeviceStep.__call__
    bufs = []

    def keep_new(cls, *args, **kwargs):
        bufs.append(new.__func__(cls, *args, **kwargs))
        return bufs[-1]

    def keep_call(self):
        how = call(self)
        b = bufs[-1]
        steps.append(dict(m={k: t.detach().clone() for k, t in b.m.items()},
                          leaves={k: t.detach().clone() for k, t in b.leaves.items()},
                          states=b.states.detach().clone()))
        return how

    trainer._Static.new = classmethod(keep_new)
    trainer._DeviceStep.__call__ = keep_call
    try:
        yield steps
    finally:
        trainer._Static.new = new
        trainer._DeviceStep.__call__ = call


def traces(steps: list, before: list, b1: float) -> list:
    """Per lane the warm-up's per-step gradients, as the optimizer got them
    (g_s = (m_s - b1 m_(s-1)) / (1 - b1)), each with the params it was taken
    at and its rollout's states [T, P, ds]."""
    out = []
    for i, p0 in enumerate(before):
        lane, m_prev, params = [], None, p0
        for st in steps:
            m = {k: t[i].double() for k, t in st["m"].items()}
            g = {k: (t - (0.0 if m_prev is None else b1 * m_prev[k])) / (1.0 - b1)
                 for k, t in m.items()}
            lane.append(dict(grad=g, params=params, states=st["states"][:, i]))
            m_prev, params = m, {k: t[i] for k, t in st["leaves"].items()}
        out.append(lane)
    return out


def setup(run: Run, sizes: dict):
    """Inputs from the seed, the port built on them, and the warm-up call,
    which the check reads: (each lane's params before it, each lane's call
    with its per-step ``trace``)."""
    run.lanes = [inp.lane_inputs(run.cfg, run.seed, i) for i in range(run.cell["lanes"])]
    agent = scenario(run.cfg, run.device, sizes)
    run.system = SYSTEMS[run.cell["mode"]](run, agent)
    before = run.system.params()
    with readout([]) as steps:
        _, out = run.system.call(0, run.cell["check_steps"])
    sync(run.device)
    for call, trace in zip(out, traces(steps, before, run.cfg["adam_b1"])):
        call["trace"] = trace
    return before, out


def window(run: Run, seconds: float, counters: dict):
    """Calls back to back for ``seconds``: (lane-steps, wall s, calls, the
    last call's index and per-lane output); the program's counters over the
    window go into ``counters``."""
    from mcpilco_tpu_torch.control import trainer
    from mcpilco_tpu_torch.ops import fused_predict as fp

    trainer.reset_graph_counts()
    fp.reset_launches()
    sync(run.device)
    t0 = time.perf_counter()
    lane_steps, calls, last, out = 0, 0, 0.0, None
    while calls == 0 or time.perf_counter() - t0 + last <= seconds + SLACK_S:
        t = time.perf_counter()
        n, out = run.system.call(1 + calls, run.cell["steps_per_call"])
        sync(run.device)
        last = time.perf_counter() - t
        lane_steps += n
        calls += 1
    wall = time.perf_counter() - t0
    counters.update(graph=dict(trainer.graph_counts), launches=dict(fp.launches),
                    launched_lanes=dict(fp.launched_lanes))
    return lane_steps, wall, calls, (calls, out)


def judges(run: Run, before, last_index=None, dtype=torch.float64):
    """The plain reference's side of the check, per lane: its posterior's
    ``heads`` and ``jitter_scale``, the warm-up call's first cost
    ``cost0`` from the same parameters and key, the calls' keys and the
    steps they were asked for."""
    mod = inp.reference_module(run.cfg)
    out = []
    for i, lane in enumerate(run.lanes):
        heads, scale = ref.posterior(mod, run.cfg, lane, dtype, run.device)
        key = run.system.keys(0)[i]
        out.append(dict(heads=heads, jitter_scale=scale, key=key,
                        cost0=ref.first_cost(mod, run.cfg, heads, before[i], key, dtype,
                                             run.device),
                        last_key=None if last_index is None else run.system.keys(last_index)[i],
                        asked=(run.cell["check_steps"], run.cell["steps_per_call"])))
    return out


def numbers(run: Run, judged, warm, before, last=None, keys=check.NUMBERS) -> dict:
    """The numbers ``keys`` (``check.py``), each the worst over the lanes."""
    mod = inp.reference_module(run.cfg)
    last = last or [None] * len(warm)
    return check.worst([check.lane_numbers(mod, run.cfg, j, w, b, l, keys)
                        for j, w, b, l in zip(judged, warm, before, last)])


def result_line(correct, attempted, failed, metrics, device, found, limits, breakdown=None):
    """The contract's last line; the compared numbers beside their limits come last."""
    line = dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics,
                device=device)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = {k: {"value": v, "limit": limits[k]} for k, v in found.items()}
    return line


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             sizes: dict = None, out=sys.stdout, err=sys.stderr) -> int:
    """One run; prints the result line last on ``out`` and the compared
    numbers last on ``err``.  Returns the exit code.  ``sizes`` ({"scenario":
    port config fields, "config": config keys, "data": dataset keys, "cell":
    workload keys}) shrinks a cell for tests on the CPU."""
    cell, cfg = load_cell(name)
    sizes = sizes or {}
    cfg = dict(cfg, **sizes.get("config", {}))
    cfg["data"] = dict(cfg["data"], **sizes.get("data", {}))
    cfg["policy"] = dict(cfg["policy"], **sizes.get("policy", {}))
    cell = dict(cell, **sizes.get("cell", {}))
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = cfg["precision"]["tf32_matmul"]
    torch.backends.cudnn.allow_tf32 = cfg["precision"]["tf32_cudnn"]
    run = Run(cell=cell, cfg=cfg, seed=seed, device=device, lanes=[])
    before, warm = setup(run, sizes.get("scenario", {}))
    sync(device)
    setup_s = time.perf_counter() - t_start
    counters = {}
    lane_steps, wall, calls, (last_index, last) = window(run, seconds, counters)
    rate = lane_steps / wall
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1}
    breakdown = None
    ctx = dict(cell=cell, cfg=cfg, info=run.info, counters=counters, window_s=wall,
               lane_steps=lane_steps, lane_steps_per_s=rate, calls=calls, records=None,
               cuda=cuda)
    if trace:
        profiled = tr.profile_call(lambda: run.system.call(1 + calls, cell["trace_steps"]),
                                   device)
        ctx["records"] = profiled
        if profiled is not None and profiled.get("steady_s"):
            device_info.update(busy_s=profiled["steady_busy_s"], window_s=profiled["steady_s"])
            breakdown = profiled["breakdown"]
        metrics = read_metrics(name, ctx)
    else:
        metrics = {"lane_steps_per_s": {"value": rate, "unit": "lane-steps/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    device_info["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device)) if cuda
                                        else 0)
    print(f"[portbench] {name} seed {seed}: {lane_steps} lane-steps in {wall:.3f} s over "
          f"{calls} calls of {cell['steps_per_call']} steps ({rate:.4f} lane-steps/s), set-up "
          f"{setup_s:.3f} s, M {run.info.get('M')}, jitter {run.info.get('jitter_scale')}, "
          f"sod {run.info.get('sod_points')}, counters {json.dumps(counters)}"
          + (f", trace {json.dumps({k: v for k, v in ctx['records'].items() if k != 'breakdown'})}"
             if ctx["records"] else ""), file=err, flush=True)
    run.system.close()
    if cuda:
        torch.cuda.empty_cache()
    limits = cell["limits"]
    judged = judges(run, before, last_index)
    found_numbers = numbers(run, judged, warm, before, last, tuple(limits))
    for i, (w, j) in enumerate(zip(warm, judged)):
        print(f"[portbench] lane {i} warm-up costs: port {[float(c) for c in w['costs']]} "
              f"reference first {j['cost0']}", file=err, flush=True)
    del judged
    found = forbidden_modules()
    if found:
        print(f"[portbench] refused: the process holds {found}", file=err, flush=True)
        return 3
    failed = sum(1 for k in limits if not found_numbers[k] <= limits[k])
    for k, v in found_numbers.items():
        print(f"check {k} {v!r} limit {limits[k]!r}", file=err, flush=True)
    line = result_line(failed == 0, len(limits), failed, metrics, device_info, found_numbers,
                       limits,
                       breakdown)
    print(json.dumps(line), file=out, flush=True)
    return 0


def read_metrics(cell_name: str, ctx: dict) -> dict:
    """Every per-layer metric whose module lists this cell (or lists none),
    as its reader finds it; a reader that finds nothing is left out."""
    out = {}
    for mod in metric_modules():
        if mod.WORKLOADS is not None and cell_name not in mod.WORKLOADS:
            continue
        value = mod.read(ctx)
        if value is not None and math.isfinite(value):
            out[mod.NAME] = {"value": value, "unit": mod.UNIT}
    return out


def metric_modules(root: str = ROOT):
    """The per-layer metric modules under ``root``/metrics, by file name (a
    metric's name may hold dots, so each is loaded from its path)."""
    out = []
    folder = os.path.join(root, "metrics")
    for f in sorted(os.listdir(folder)):
        if f.endswith(".py") and not f.startswith("_"):
            spec = importlib.util.spec_from_file_location(
                "portbench.metrics._" + f[:-3].replace(".", "_"), os.path.join(folder, f))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out.append(mod)
    return out
