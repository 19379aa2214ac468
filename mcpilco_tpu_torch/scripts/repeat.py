"""The multi-seed outcome protocol: train a range of seeds, report the success
rate and the quartiles of the final trial's cumulative cost (the JAX
package's ``scripts/repeat.py``; its ``--platform`` is ``--device`` here).

    python -m mcpilco_tpu_torch.scripts.repeat --scenario cartpole --num-seeds 50
    python -m mcpilco_tpu_torch.scripts.repeat --farm-batch 8 --resume          # SeedFarm batches
    python -m mcpilco_tpu_torch.scripts.repeat --scenario ur5 --jobs 8 --device cpu
    python -m mcpilco_tpu_torch.scripts.repeat --no-farm --extra-flag=--kernel=se
    python -m mcpilco_tpu_torch.scripts.repeat --supervise 3 --resume           # relaunch on stalls
    python -m mcpilco_tpu_torch.scripts.repeat --smoke --device cpu --num-seeds 2

How the seeds run:

- **The farm** (the default for the scenarios whose plant runs on the
  device, ``FARMABLE``; ``--farm`` also takes ``cartpole_mujoco``, whose
  MuJoCo plant the farm steps seed by seed on the host): ``--farm-batch``
  seeds at a time as lanes of ``parallel.multiseed.SeedFarm``, in this
  process.  Each batch's output is kept in every seed's log dir.
- **Subprocess seeds** (``--jobs N``): each seed runs ``python -m
  mcpilco_tpu_torch.scripts.train_<scenario>`` with ``--seed``,
  ``--log-dir``, the scenario's flags, ``--smoke``, ``--trials``,
  ``--auto-resume`` under ``--resume``, the ``--extra-flag`` flags and
  ``--device``, N seeds at once (on the card they share it; UR5 seeds on
  the CPU's cores).  A seed succeeds when its output says ``success:
  True``; its cost is the ``cumulative cost:`` line, both looked for in the
  whole output.
- **In process** (``--in-process``, and every other sequential run:
  ``--no-farm`` without ``--jobs``, and ``ur5``): one seed after another in
  this process, each with the config its train script's flags give
  (``parse``), ``--scenario-kw`` on top, through the script's ``run``,
  its output on the console and in its log, scored on the trained agent.
  Where the JAX driver starts a process per seed, the port runs a
  sequential sweep here by default: no seed pays a new CUDA context and
  kernel load, and ``--scenario-kw`` reaches config fields no script flag
  sets.  ``--jobs 1`` runs the same seeds one after another as
  subprocesses, which keeps a seed whose kernel fault spoils its CUDA
  context from spoiling the next.

Every seed's output goes to ``<log dir>/stdout.log``, its log dir being
``results_tmp/torch/<scenario>[_<tag>]_<seed>``.  The summary,
``results_tmp/torch/repeat_<scenario>[_<tag>].json``, has the keys of the
JAX driver's (and ``smoke`` and ``trials``, which say whether the sweep
was cut down) and is rewritten after every seed or batch, so ``--resume``
skips the seeds already done (a resumed sequential seed continues from its
newest completed trial).

A seed that died of the machine, not of the program (``INFRA_MARKERS``: no
CUDA device, a CUDA driver that failed to initialize, a busy or
unavailable device, an uncorrectable ECC error; it did not succeed and
exited non-zero) is no outcome: it leaves the denominator for
``infra_error_seeds`` and runs again under ``--resume``.  A kernel fault
(``KERNEL_FAULT_MARKERS``: an illegal memory access, a misaligned address,
a device-side assert, a failed ``nvcc`` build) is a failed seed, whatever
else its output says.

Exit codes: 0 done; 86 (``STOP_EXIT_CODE``) stopped by the file
``results_tmp/torch/repeat_<scenario>[_<tag>].STOP`` at a seed or batch
boundary (the file is consumed; ``--resume`` goes on); 87
(``WATCHDOG_EXIT_CODE``) a stall of ``--stall-secs``: in process, neither
seed output nor an optimizer iteration, host read or fit epoch for that
long (a healthy optimization prints nothing for minutes, but its
iterations count); in the farm, no return to the host (collection, fit, read of the
optimizer's lanes) for that long, or for ``FARM_FIRST_TICK_GRACE_S``
before the process's first one.  The watchdog
dumps every thread's stack, saves the stuck seed's log and exits; the
seeds done stay in the summary.  ``--supervise N`` runs the sweep as a
child and relaunches it with ``--resume`` after an exit 87 or a crash
after its first minute, up to N times, each time once a probe process has
put a tensor on the card (no probe with ``--device cpu``); it does not
relaunch after an exit 86, and passes on a child's failure within its
first minute.
"""

import argparse
import ast
import concurrent.futures as cf
import contextlib
import dataclasses
import faulthandler
import io
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import torch

from ..control.trainer import graph_counts
from ..models.gp import fit_counts
from ..parallel.multiseed import SeedFarm
from ..scenarios import cartpole, cartpole_mujoco, cartpole_pms, furuta, ur5
from . import (train_cartpole, train_cartpole_mujoco, train_cartpole_pms, train_furuta,
               train_ur5)

OUT_DIR = os.path.join("results_tmp", "torch")
# the checkout's root, put on a child process's path
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WATCHDOG_EXIT_CODE = 87
STOP_EXIT_CODE = 86
# the farm watchdog's wait for the process's first return to the host (the
# kernels' nvcc build, the first fit and the first graph capture)
FARM_FIRST_TICK_GRACE_S = 2700
# a child of --supervise that fails sooner failed for a reason a relaunch
# keeps (a bad flag, a refused resume)
SUPERVISE_MIN_CHILD_S = 60
# the sweep that --supervise runs as a child
SWEEP_CMD = [sys.executable, "-m", "mcpilco_tpu_torch.scripts.repeat"]


def _swung_up(scen):
    return lambda agent: scen.swingup_success(agent.trials[-1].true)


# scenario -> (scenario module, train script, success of a trained agent)
SCENARIOS = {
    "cartpole": (cartpole, train_cartpole, _swung_up(cartpole)),
    "cartpole_multi_init": (cartpole, train_cartpole, _swung_up(cartpole)),
    "cartpole_pms": (cartpole_pms, train_cartpole_pms, _swung_up(cartpole_pms)),
    "furuta": (furuta, train_furuta, _swung_up(furuta)),
    "cartpole_mujoco": (cartpole_mujoco, train_cartpole_mujoco, _swung_up(cartpole_mujoco)),
    "ur5": (ur5, train_ur5, ur5.tracking_success),
}
# the scenario's own flags of its train script
SCENARIO_FLAGS = {"cartpole_multi_init": ["--multi-init"]}
# the farm is the default for the scenarios whose plant runs on the device;
# cartpole_mujoco's host plant farms on request (--farm)
FARMABLE = ("cartpole", "cartpole_multi_init", "cartpole_pms", "furuta")
FARM_SUPPORTED = FARMABLE + ("cartpole_mujoco",)

# a seed that died of one of these failed for the machine, not the program
INFRA_MARKERS = (
    "No CUDA GPUs are available",
    "no CUDA-capable device is detected",
    "Found no NVIDIA driver on your system",
    "Torch not compiled with CUDA enabled",
    "CUDA driver initialization failed",
    "CUDA error: initialization error",
    "CUDA-capable device(s) is/are busy or unavailable",
    "uncorrectable ECC error encountered",
)
# a seed whose output holds one of these failed for the program
KERNEL_FAULT_MARKERS = (
    "an illegal memory access",
    "misaligned address",
    "device-side assert",
    "nvcc failed",
)


def _is_infra_error(out: str) -> bool:
    return (any(m in out for m in INFRA_MARKERS)
            and not any(m in out for m in KERNEL_FAULT_MARKERS))


def _classify_infra(out: str, success: bool, rc: int) -> bool:
    """An infra event only when the seed died of one: a seed that logged a
    recovered error and finished with an outcome is an outcome."""
    return not success and rc != 0 and _is_infra_error(out)


def _parse_cost(out: str):
    """The final trial's cumulative cost, if the output has its line."""
    for line in out.splitlines():
        if "cumulative cost:" in line:
            try:
                return float(line.rsplit(":", 1)[1])
            except ValueError:
                pass
    return None


def seed_log_dir(scenario: str, seed: int, tag: str = "") -> str:
    return os.path.join(OUT_DIR, f"{scenario}{f'_{tag}' if tag else ''}_{seed}")


def _save_seed_log(log_dir: str, text: str) -> None:
    """A seed's captured output, kept after the sweep (a crashed seed's
    output would otherwise go with its buffer)."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "stdout.log"), "w") as f:
        f.write(text)


def _seed_argv(args, seed: int, extra: list) -> list:
    return (["--seed", str(seed), "--log-dir", seed_log_dir(args.scenario, seed, args.out_tag)]
            + SCENARIO_FLAGS.get(args.scenario, []) + extra + ["--device", args.device])


def _scenario_kw(args) -> dict:
    kw = {}
    for item in args.scenario_kw:
        k, _, v = item.partition("=")
        try:
            kw[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            kw[k] = v  # bare strings (e.g. vel_est=savgol)
    return kw


def seed_config(args, seed: int, extra: list):
    """One seed's config: what its train script's flags give (``parse``),
    ``--scenario-kw`` on top.  Returns (config, the script's flags)."""
    cfg, flags = SCENARIOS[args.scenario][1].parse(_seed_argv(args, seed, extra))
    kw = _scenario_kw(args)
    return (dataclasses.replace(cfg, **kw) if kw else cfg), flags


def _child_env() -> dict:
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path if path else ""))


def run_seed(args, seed: int, extra: list):
    """One seed as a subprocess of its train script; (seed, success, exit
    code, cost, infra)."""
    script = SCENARIOS[args.scenario][1]
    cmd = [sys.executable, "-u", "-m", script.__name__] + _seed_argv(args, seed, extra)
    r = subprocess.run(cmd, capture_output=True, text=True, env=_child_env())
    _save_seed_log(seed_log_dir(args.scenario, seed, args.out_tag),
                   r.stdout + "\n==== stderr ====\n" + r.stderr)
    success = "success: True" in r.stdout
    return (seed, success, r.returncode, _parse_cost(r.stdout),
            _classify_infra(r.stdout + r.stderr, success, r.returncode))


# The in-process watchdog's view: "buf" is the running seed's captured
# output (None between seeds); "sig" the seed's progress (``_progress``)
# when it last moved, at time "t".
_WATCH = {"buf": None, "sig": None, "t": 0.0, "seed": None, "log_dir": None}


def _progress(buf) -> tuple:
    """What moves while a seed is healthy: its output, the optimizer's
    iterations and host reads (``trainer.graph_counts``; the host issues an
    iteration only once the one ``POLL_LAG`` before it has ended on the
    card, so a hung kernel stops them) and the model fits' epochs
    (``gp.fit_counts``), however long an optimization or a fit runs without
    printing."""
    return (buf, buf.tell(), graph_counts["uncaptured"], graph_counts["replays"],
            graph_counts["reads"], fit_counts["epochs"])


def _watch_period(stall_secs: float) -> float:
    return min(30.0, max(stall_secs / 4.0, 1.0))


def _stall_exit(msg: str) -> None:
    sys.stderr.write(msg)
    faulthandler.dump_traceback(file=sys.stderr)
    sys.stderr.flush()
    os._exit(WATCHDOG_EXIT_CODE)


def _start_watchdog(stall_secs: float) -> threading.Event:
    """Exit the process (``WATCHDOG_EXIT_CODE``) when the running seed has
    not moved (``_progress``: no output, optimizer iteration or fit epoch) for
    ``stall_secs``: a call that hangs on the card cannot be interrupted,
    but a daemon thread still runs while it waits.  Saves the seed's output
    so far first.  Set the returned event to stop watching."""
    stop = threading.Event()

    def run():
        while not stop.wait(_watch_period(stall_secs)):
            buf, now = _WATCH["buf"], time.time()
            if buf is None:  # between seeds
                _WATCH["t"] = now
                continue
            try:
                sig = _progress(buf)
            except ValueError:  # closed while we looked
                _WATCH["t"] = now
                continue
            if sig != _WATCH["sig"]:
                _WATCH.update(sig=sig, t=now)
                continue
            if now - _WATCH["t"] <= stall_secs:
                continue
            msg = (f"[repeat] WATCHDOG: seed {_WATCH['seed']} wrote no output and ran no "
                   f"optimizer iteration or fit epoch for {int(now - _WATCH['t'])} s; exiting "
                   f"{WATCHDOG_EXIT_CODE} (re-run with --resume to go on)\n")
            try:
                _save_seed_log(_WATCH["log_dir"], buf.getvalue() + f"\n==== {msg.strip()} ====\n")
            except Exception:
                pass
            _stall_exit(msg)

    threading.Thread(target=run, daemon=True, name="repeat-watchdog").start()
    return stop


def _start_farm_watchdog(stall_secs: float, state: dict) -> threading.Event:
    """Exit the process (``WATCHDOG_EXIT_CODE``) when the farm has not
    returned to the host (``state["t"]``, set by ``SeedFarm.progress_cb``
    at every collection, fit and read of the optimizer's lanes) for
    ``stall_secs``, or ``FARM_FIRST_TICK_GRACE_S`` before the process's
    first return (``state["ticks"]``): a healthy farm returns at least
    every ``chunk_target_s`` seconds of optimization, however long a trial
    runs without printing.  Saves the batch's output so far in each of its
    seeds' log dirs first.  Set the returned event to stop watching."""
    stop = threading.Event()

    def run():
        while not stop.wait(_watch_period(stall_secs)):
            silent = time.time() - state["t"]
            budget = stall_secs if state["ticks"] else max(stall_secs, FARM_FIRST_TICK_GRACE_S)
            if silent <= budget:
                continue
            msg = (f"[repeat] FARM WATCHDOG: no return to the host for {int(silent)} s in "
                   f"batch {state['batch']}; exiting {WATCHDOG_EXIT_CODE} (re-run with --resume;"
                   f" the finished batches are in the summary)\n")
            try:
                text = state["buf"].getvalue() + f"\n==== {msg.strip()} ====\n"
                for log_dir in state["log_dirs"]:
                    _save_seed_log(log_dir, text)
            except Exception:
                pass
            _stall_exit(msg)

    threading.Thread(target=run, daemon=True, name="repeat-farm-watchdog").start()
    return stop


class _Tee(io.TextIOBase):
    """Writes to every one of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for stream in self.streams:
            stream.write(s)
        return len(s)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def run_seed_inprocess(args, seed: int, extra: list):
    """One seed in this process through its train script's ``run``, its
    output shown and captured (a part of the watchdog's heartbeat) and
    saved; scored on the trained agent.  (seed, success, exit code, cost,
    infra)."""
    _, script, success = SCENARIOS[args.scenario]
    log_dir = seed_log_dir(args.scenario, seed, args.out_tag)
    buf = io.StringIO()
    _WATCH.update(buf=buf, sig=None, t=time.time(), seed=seed, log_dir=log_dir)
    ok, cost, rc = False, None, 0
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            cfg, flags = seed_config(args, seed, extra)
            agent, _ = script.run(cfg, flags.device, flags.auto_resume)
        ok, cost = bool(success(agent)), round(agent.trial_cumulative_cost(), 4)
    except SystemExit as e:  # the script's flags refused
        rc = e.code if isinstance(e.code, int) else 1
    except Exception:  # one crashed seed must not lose the sweep
        buf.write("\n==== exception ====\n" + traceback.format_exc())
        print(f"[repeat] seed {seed} raised; its log: {log_dir}/stdout.log", file=sys.stderr)
        rc = 1
    finally:
        _WATCH["buf"] = None
    out = buf.getvalue()
    _save_seed_log(log_dir, out)
    return seed, ok, rc, cost, _classify_infra(out, ok, rc)


def _stop_path(args) -> str:
    return summary_path(args)[: -len(".json")] + ".STOP"


def _check_stop(args) -> bool:
    """True, once, when the STOP file is there: the sweep then exits at
    this seed or batch boundary, on the host (never inside a call on the
    card).  The file is consumed, so the next launch runs."""
    path = _stop_path(args)
    if not os.path.exists(path):
        return False
    try:
        os.remove(path)
    except OSError:
        pass
    print(f"[repeat] STOP file {path}: exiting at the boundary (resume with --resume)",
          flush=True)
    return True


def run_sequential(args, seeds, extra, results, costs, infra) -> int:
    """The seeds one after another (``--jobs`` 1 or in process), or as
    ``--jobs`` subprocesses at once; the STOP file is looked for before
    every seed starts.  Returns 0, or ``STOP_EXIT_CODE``."""
    inproc = args.jobs is None
    runner = run_seed_inprocess if inproc else run_seed

    def record(outcome):
        seed, ok, rc, cost, inf = outcome
        results[seed], costs[seed] = ok, cost
        (infra.add if inf else infra.discard)(seed)
        print(f"[repeat] seed {seed}: success={ok} rc={rc} cost={cost}"
              + (" [INFRA ERROR: excluded]" if inf else ""), flush=True)
        write_summary(args, results, costs, infra, complete=False)

    if inproc or args.jobs == 1:
        for s in seeds:
            if _check_stop(args):
                return STOP_EXIT_CODE
            record(runner(args, s, extra))
        return 0
    todo, running, stopped = list(seeds), set(), False
    with cf.ThreadPoolExecutor(args.jobs) as ex:
        while todo or running:
            while todo and len(running) < args.jobs and not stopped:
                stopped = _check_stop(args)
                if not stopped:
                    running.add(ex.submit(runner, args, todo.pop(0), extra))
            if not running:
                break
            done, running = cf.wait(running, return_when=cf.FIRST_COMPLETED)
            for f in done:
                record(f.result())
    return STOP_EXIT_CODE if stopped else 0


def _farm_batch(args, scen, batch, extra, tick, results, costs) -> None:
    """One batch of seeds through ``SeedFarm.run``, each scored on its final
    trial."""
    cfg, _ = seed_config(args, batch[0], extra)
    agent, kwargs = scen.build(cfg, args.device)
    farm = SeedFarm(agent, batch, policy_init_fn=lambda k: scen.policy_init(
        cfg, agent.policy, k, args.device), progress_cb=tick)
    res = farm.run(**kwargs)
    for i, s in enumerate(batch):
        # a per-trial cost schedule scores the final trial with its own row
        stage = agent.cost.stage_costs(torch.as_tensor(res.final_true[i][:, None, :]),
                                       torch.as_tensor(res.final_inputs[i][:, None, :]),
                                       len(res.trial_logs) - 1)
        results[s] = scen.swingup_success(res.final_true[i])
        costs[s] = round(float(torch.sum(stage)), 4)
        print(f"[repeat] seed {s}: success={results[s]} cost={costs[s]}", flush=True)


def run_farm(args, seeds, extra, results, costs) -> int:
    """``--farm-batch`` seeds at a time as lanes of one ``SeedFarm``, the
    STOP file looked for before every batch, the farm watchdog on its
    ``progress_cb``.  Returns 0, or ``STOP_EXIT_CODE``."""
    scen = SCENARIOS[args.scenario][0]
    watch = {"t": time.time(), "ticks": 0, "batch": None, "log_dirs": [], "buf": io.StringIO()}
    stop = _start_farm_watchdog(args.stall_secs, watch) if args.stall_secs else None

    def tick():
        watch.update(t=time.time(), ticks=watch["ticks"] + 1)

    try:
        for lo in range(0, len(seeds), args.farm_batch):
            if _check_stop(args):
                return STOP_EXIT_CODE
            batch = seeds[lo: lo + args.farm_batch]
            buf = io.StringIO()
            watch.update(batch=batch, t=time.time(), buf=buf, log_dirs=[
                seed_log_dir(args.scenario, s, args.out_tag) for s in batch])
            try:
                with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
                    _farm_batch(args, scen, batch, extra, tick, results, costs)
            finally:  # a batch that raised keeps its output too
                for log_dir in watch["log_dirs"]:
                    _save_seed_log(log_dir, buf.getvalue())
            write_summary(args, results, costs, set(), complete=False)
    finally:
        if stop is not None:
            stop.set()
    return 0


def _wait_for_card(device: str, window_s: float = 900.0, probe_s: float = 120.0,
                   pause_s: float = 15.0) -> bool:
    """True once a probe process has put a tensor on ``device`` and
    synchronized, trying again for up to ``window_s``; at once for a
    device that is not CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return True
    code = (f"import torch; d = torch.device({str(dev)!r}); x = torch.ones(1024, device=d); "
            f"torch.cuda.synchronize(d); print('card ok', float(x.sum()))")
    deadline = time.time() + window_s
    while True:
        try:
            r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                               timeout=probe_s)
            if r.returncode == 0:
                print(f"[repeat-supervisor] {r.stdout.strip()}", flush=True)
                return True
            print(f"[repeat-supervisor] probe rc={r.returncode}: {r.stderr.strip()[-300:]}",
                  flush=True)
        except subprocess.TimeoutExpired:
            print(f"[repeat-supervisor] probe hung for {probe_s:.0f} s", flush=True)
        if time.time() + pause_s > deadline:
            print(f"[repeat-supervisor] no card after {window_s:.0f} s: giving up", flush=True)
            return False
        time.sleep(pause_s)


def supervise(args, argv: list) -> int:
    """The sweep of ``argv`` (less ``--supervise``) as a child process,
    relaunched with ``--resume`` as the module docstring says."""
    child, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--supervise":
            skip = True
        elif not a.startswith("--supervise="):
            child.append(a)
    rc = 1
    for attempt in range(args.supervise + 1):
        cmd = child + (["--resume"] if attempt and "--resume" not in child else [])
        print(f"[repeat-supervisor] launch {attempt + 1}/{args.supervise + 1}: {' '.join(cmd)}",
              flush=True)
        t0 = time.time()
        rc = subprocess.call(SWEEP_CMD + cmd, env=_child_env())
        secs = time.time() - t0
        if rc == 0:
            print("[repeat-supervisor] sweep complete", flush=True)
            return 0
        if rc == STOP_EXIT_CODE:
            print("[repeat-supervisor] stopped by the STOP file: not relaunching", flush=True)
            return rc
        print(f"[repeat-supervisor] child exited rc={rc} after {secs:.0f} s", flush=True)
        if rc != WATCHDOG_EXIT_CODE and secs < SUPERVISE_MIN_CHILD_S:
            print("[repeat-supervisor] a failure in the child's first minute: not relaunching",
                  flush=True)
            return rc
        if attempt == args.supervise:
            break
        if not _wait_for_card(args.device):
            return rc
    print(f"[repeat-supervisor] giving up after {args.supervise + 1} launches (rc={rc})",
          flush=True)
    return rc


def summary_path(args) -> str:
    tag = f"_{args.out_tag}" if args.out_tag else ""
    return os.path.join(OUT_DIR, f"repeat_{args.scenario}{tag}.json")


def load_resume(args):
    """The finished seeds of an earlier (partial) sweep of this scenario and
    tag; its infra seeds are not among them, so they run again."""
    path = summary_path(args)
    if not os.path.exists(path):
        return {}, {}
    with open(path) as f:
        prev = json.load(f)
    results = {int(k): bool(v) for k, v in prev.get("per_seed", {}).items()}
    costs = {int(k): prev.get("per_seed_cost", {}).get(k) for k in prev.get("per_seed", {})}
    print(f"[repeat] resume: {len(results)} completed seeds loaded from {path}")
    return results, costs


def write_summary(args, results, costs, infra, complete):
    """Write the summary with the keys of the JAX driver's: the success rate
    and cost quartiles (linear interpolation) over the seeds that are no
    infra event, per-seed outcomes and costs, the infra seeds, the tag, the
    flags passed through and the config overrides; and whether the sweep
    was cut to the smoke size or to ``--trials`` (``summarize_results``
    keeps such a sweep in a row of its own)."""
    results = {s: v for s, v in results.items() if s not in infra}
    costs = {s: v for s, v in costs.items() if s not in infra}
    rate = sum(results.values()) / max(len(results), 1)
    known = sorted(c for c in costs.values() if c is not None)
    quartiles = None
    if known:
        def q(p):
            i = p * (len(known) - 1)
            lo, hi = int(i), min(int(i) + 1, len(known) - 1)
            return round(known[lo] + (i - lo) * (known[hi] - known[lo]), 4)
        quartiles = {"q25": q(0.25), "median": q(0.5), "q75": q(0.75),
                     "min": known[0], "max": known[-1]}
    summary = {"scenario": args.scenario, "seeds": sorted(results), "success_rate": rate,
               "final_trial_cost_quartiles": quartiles,
               "per_seed": {str(k): bool(v) for k, v in sorted(results.items())},
               "per_seed_cost": {str(k): costs[k] for k in sorted(costs)},
               "infra_error_seeds": sorted(infra), "tag": args.out_tag,
               "extra_flags": list(args.extra_flag), "scenario_kw": args.scenario_kw,
               "smoke": bool(args.smoke or "--smoke" in args.extra_flag), "trials": args.trials,
               "complete": complete}
    out = summary_path(args)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(out + ".tmp", "w") as f:
        json.dump(summary, f, indent=1)
    os.replace(out + ".tmp", out)
    return summary, out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("repeat over seeds")
    p.add_argument("--scenario", default="cartpole", choices=sorted(SCENARIOS))
    p.add_argument("--first-seed", type=int, default=1)
    p.add_argument("--num-seeds", type=int, default=50)
    p.add_argument("--seeds", type=str, default=None,
                   help="comma-separated seed list (e.g. 5,10); overrides --first-seed and "
                        "--num-seeds")
    p.add_argument("--jobs", type=int, default=None,
                   help="run each seed as a subprocess of its train script, this many at once")
    p.add_argument("--device", type=str, default="cuda", help="cpu to run on the CPU")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--in-process", action="store_true",
                   help="run the seeds one after another in this process (the default of a "
                        "sequential run)")
    p.add_argument("--farm", action=argparse.BooleanOptionalAction, default=None,
                   help="train the seeds as lanes of a SeedFarm: the default for "
                        f"{', '.join(FARMABLE)}; also takes cartpole_mujoco; --no-farm runs "
                        "them one after another")
    p.add_argument("--farm-batch", type=int, default=4, help="seeds per farm batch")
    p.add_argument("--trials", type=int, default=None, help="override the trial count")
    p.add_argument("--extra-flag", action="append", default=[],
                   help="a flag passed through to the train script (repeatable; "
                        "--extra-flag=--delta-cap=2.0 for a flag with a value); not with the "
                        "farm, which takes config overrides through --scenario-kw")
    p.add_argument("--scenario-kw", action="append", default=[],
                   help="scenario-config field override as key=value (repeatable, e.g. "
                        "--scenario-kw gp_epochs=500); values parse as Python literals, "
                        "else as strings; farm and in-process runs")
    p.add_argument("--out-tag", type=str, default="",
                   help="suffix of the summary file name, so that A/B arms stay apart")
    p.add_argument("--resume", action="store_true",
                   help="skip the seeds of this scenario/tag's summary (its infra seeds run "
                        "again); a sequential seed continues from its newest completed trial")
    p.add_argument("--stall-secs", type=int, default=900,
                   help=f"exit {WATCHDOG_EXIT_CODE} when the sweep stalls this long: in process "
                        "no seed output, optimizer iteration or fit epoch, in the farm no "
                        "return to the host (with "
                        f"{FARM_FIRST_TICK_GRACE_S} s before the first); 0 disables")
    p.add_argument("--supervise", type=int, default=0, metavar="N",
                   help=f"run the sweep as a child and relaunch it with --resume after an exit "
                        f"{WATCHDOG_EXIT_CODE} or a later crash, up to N times, once a probe "
                        "reaches the card; 0 = off")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    if args.supervise:
        return supervise(args, argv)
    if args.farm and args.scenario not in FARM_SUPPORTED:
        raise SystemExit(f"--farm does not take {args.scenario} (nor does the JAX package's "
                         f"repeat); it takes {', '.join(FARM_SUPPORTED)}")
    if args.jobs is not None and (args.jobs < 1 or args.in_process or args.farm):
        raise SystemExit("--jobs N runs N seed subprocesses at once (N >= 1), not with "
                         "--in-process or --farm")
    farm_default = args.scenario in FARMABLE and not args.in_process and args.jobs is None
    if args.extra_flag and (args.farm or (args.farm is None and farm_default)):
        raise SystemExit("--extra-flag needs --no-farm (or a scenario the farm does not take); "
                         "farm runs take config overrides through --scenario-kw")
    if args.farm is None:
        args.farm = farm_default
    if args.scenario_kw and args.jobs is not None:
        raise SystemExit("--scenario-kw is for the farm and in-process runs; subprocess seeds "
                         "take script flags through --extra-flag")

    extra = ["--smoke"] if args.smoke else []
    if args.resume and not args.farm:
        # only a resumed sweep continues its in-flight seed from a checkpoint:
        # a fresh sweep must not replay an earlier sweep's seed of that name
        extra += ["--auto-resume"]
    if args.trials is not None:
        extra += ["--trials", str(args.trials)]
    for flag in args.extra_flag:
        extra += flag.split("=", 1) if flag.startswith("--") and "=" in flag else [flag]
    if args.seeds:
        seeds = [int(s) for s in args.seeds.split(",")]
    else:
        seeds = list(range(args.first_seed, args.first_seed + args.num_seeds))
    results, costs = load_resume(args) if args.resume else ({}, {})
    seeds = [s for s in seeds if s not in results]
    if args.resume and not seeds:
        print("[repeat] resume: nothing left to run")
    infra = set()
    watchdog = None
    if not args.farm and args.jobs is None and args.stall_secs:
        watchdog = _start_watchdog(args.stall_secs)
    try:
        if args.farm:
            rc = run_farm(args, seeds, extra, results, costs)
        else:
            rc = run_sequential(args, seeds, extra, results, costs, infra)
    finally:
        if watchdog is not None:
            watchdog.set()
    if rc == STOP_EXIT_CODE:
        return rc
    summary, out = write_summary(args, results, costs, infra, complete=True)
    print(json.dumps(summary, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
