"""Tiny sizes of each cell, for runs on the CPU: 8 particles, a 5-step
horizon, 10 basis functions, 2 trials of 12 steps, calls of 3 steps."""

import io
import json
import time

HORIZON = {"cartpole": (0.05, 5), "furuta": (0.02, 5)}


def sizes(cell: str, lanes: int = None) -> dict:
    config = "furuta" if cell.startswith("furuta") else "cartpole"
    dt, h = HORIZON[config]
    out = {"scenario": {"num_particles": 8, "T_control": dt * h, "num_basis": 10},
           "config": {"num_particles": 8, "horizon": h},
           "policy": {"num_basis": 10},
           "data": {"trials": 2, "steps": 12},
           "cell": {"steps_per_call": 3, "trace_steps": 3}}
    if lanes is not None:
        out["cell"]["lanes"] = lanes
    return out


def run(cell: str, trace: bool = False, seed: int = 2147483999, lanes: int = None):
    """One tiny run on the CPU: (exit code, the result line, stderr's lines)."""
    from portbench import harness

    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(cell, seed, 0.2, trace, "cpu", time.perf_counter(),
                          sizes=sizes(cell, lanes=2 if lanes is None and "farm" in cell
                                      else lanes), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue().strip().splitlines()
