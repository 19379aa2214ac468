"""The readers of the per-layer metrics: each takes the run's ``ctx``
(``harness.run_cell``: the window's counters and rate, the cell and
configuration, and the traced call's summary under "records") and returns
the number, or None where the run holds nothing to read.  The metric files
under ``metrics/`` name a reader and declare the metric."""

from portbench.work import flops


def capture_s(ctx):
    """Seconds per CUDA-graph capture of the optimizer step (capture and
    instantiation) over the window's calls: the optimizer's own clock."""
    g = ctx["counters"]["graph"]
    return g["captures_s"] / g["captures"] if g["captures"] else None


def outside_replay_share(ctx):
    """The window's share outside the graph's replay chunks: each call's
    probe rollout, uncaptured warm-up iteration, capture and host reads, and
    the window's own bookkeeping (100 (1 - replay chunks' s / window s))."""
    g = ctx["counters"]["graph"]
    return 100.0 * (1.0 - g["replays_s"] / ctx["window_s"]) if g["replays"] else None


def lane_occupancy(ctx):
    """A farm's lane-steps done over the lane-iterations it ran (iterations,
    uncaptured and replayed, times lanes): a finished lane runs masked."""
    g = ctx["counters"]["graph"]
    iters = g["uncaptured"] + g["replays"]
    return 100.0 * ctx["lane_steps"] / (iters * ctx["cell"]["lanes"]) if iters else None


def idle_share(ctx):
    """1 - the device's busy seconds per replay (the union of its kernel and
    copy records over the traced call's replays) over the host's seconds per
    replay in the untraced window (the optimizer's clock of its replay
    chunks, reads included): CUPTI's records stretch the traced replays'
    own span about twofold on the flagship."""
    r, g = ctx["records"], ctx["counters"]["graph"]
    if not r or not r.get("replays") or not g["replays"]:
        return None
    return 100.0 * (1.0 - (r["steady_busy_s"] / r["replays"]) / (g["replays_s"] / g["replays"]))


def kernels_per_iter(ctx):
    """Kernel records per optimizer iteration over the traced call's replays."""
    r = ctx["records"]
    return r["steady_kernels"] / r["replays"] if r and r.get("replays") else None


def roofline(kernel: str):
    """A kernel's share of its roofline: the frozen work's bound at the
    launch's shapes (lanes, particles, points, heads, dims) over the
    kernel's device time per launch in the traced call's replays."""
    work_of = {"k1": flops.k1_work, "k2": flops.k2_work}[kernel]

    def read(ctx):
        r, cfg = ctx["records"], ctx["cfg"]
        if not r or not r.get(kernel + "_launches") or cfg["k_structure"] is None:
            return None
        work = work_of(ctx["cell"]["lanes"], cfg["num_particles"], ctx["info"]["M"],
                       cfg["k_structure"] == "se+p2", cfg["num_heads"], cfg["gp_input_dim"])
        return 100.0 * flops.bound_s(work) / (r[kernel + "_s"] / r[kernel + "_launches"])
    return read


def step_mfu(ctx):
    """The configuration's analytic FLOPs per lane-step at the run's M times
    the window's lane-steps per second, over the H100's 67 TFLOP/s float32
    peak; off the card there is nothing to read."""
    if not ctx["cuda"]:
        return None
    f = flops.lane_step_flops(ctx["cfg"], ctx["info"]["M"])
    return 100.0 * f * ctx["lane_steps_per_s"] / flops.PEAK_FP32_FLOPS
