"""The traced sub-window: one call of the window's own kind, profiled with
``torch.profiler``'s CUDA activity (the device's records and the host's CUDA
API calls; recording every host op would slow the call's uncaptured
iteration many times over), read from the profiler's raw kineto records
(building the host event tree takes seconds per 100K records, and one
flagship iteration issues ~13.8K kernels).

The replays of the call's CUDA graph are the records that share one
launch's correlation id, at least ``REPLAY_MIN`` of them; their span, from
the first replay's first record to the last replay's last, is the steady
part of the call and the traced window the result line reports (its busy
and wall seconds).  The breakdown covers the whole call: the device ops
that took most time, and the longest idle gaps, each named by the host's
innermost CUDA API call at its middle.  A profile whose replays differ in
size, or that shows fewer replays than the optimizer ran, lost records and
is taken again, up to ``ATTEMPTS`` times.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

REPLAY_MIN = 100
ATTEMPTS = 3
GAPS = 10


def _union(intervals, lo=None, hi=None):
    """Merged [start, end) intervals, clipped to [lo, hi]."""
    out = []
    for s, e in sorted(intervals):
        if lo is not None:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(merged):
    return sum(e - s for s, e in merged)


def _records(prof):
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        row = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            # a span's shadow on the device's timeline is no device work
            if e.is_user_annotation():
                continue
            dev.append(row + (e.correlation_id(),))
        else:
            host.append(row)
    return dev, host


def _replays(dev):
    groups = defaultdict(list)
    for name, s, e, corr in dev:
        groups[corr].append((s, e))
    return [g for g in groups.values() if len(g) >= REPLAY_MIN]


def _fault(replays, replays_run):
    sizes = [len(g) for g in replays]
    if sizes and min(sizes) != max(sizes):
        return f"graph replays of {sorted(set(sizes))} records"
    if len(replays) != replays_run:
        return f"{len(replays)} graph replays seen of {replays_run} run"
    return None


def _label(host, t):
    """The innermost host record running at ``t``; "host" where the host ran
    no CUDA API call."""
    best = None
    for name, s, e in host:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "host"


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def summarize(dev, host, wall_s: float) -> dict:
    """The numbers the per-layer readers take from one profiled call."""
    merged = _union([(s, e) for _, s, e, _ in dev])
    reps = _replays(dev)
    out = dict(busy_s=_covered(merged) / 1e9, wall_s=wall_s, replays=len(reps))
    by_name = defaultdict(float)
    for name, s, e, _ in dev:
        by_name[name] += (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:GAPS]
    starts = [s for _, s, _ in host] + [s for _, s, _, _ in dev]
    ends = [e for _, _, e in host] + [e for _, _, e, _ in dev]
    edges = [min(starts)] + [x for iv in merged for x in iv] + [max(ends)]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:GAPS]
    out["breakdown"] = {"device_ops": [[n, t] for n, t in ops],
                        "idle_gaps": [[_label(host, s + d / 2), d / 1e9] for d, s in gaps]}
    if reps:
        lo = min(s for g in reps for s, _ in g)
        hi = max(e for g in reps for _, e in g)
        inside = [r for r in dev if r[1] >= lo and r[2] <= hi]
        out["steady_s"] = (hi - lo) / 1e9
        out["steady_busy_s"] = _covered(_union([(s, e) for _, s, e, _ in dev], lo, hi)) / 1e9
        out["steady_kernels"] = sum(1 for r in inside if _is_kernel(r[0]))
        for key, marks, count in (("k1", ("k1_forward", "k1_gen"), "k1_forward"),
                                  ("k2", ("k2_backward_xstar",), "k2_backward_xstar")):
            out[key + "_s"] = sum((e - s) / 1e9 for n, s, e, _ in inside
                                  if any(m in n for m in marks))
            out[key + "_launches"] = sum(1 for n, *_ in inside if count in n)
    return out


def profile_call(call, device):
    """Profile ``call()`` on the card and summarize it; None off the card."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    from mcpilco_tpu_torch.control import trainer

    faults = []
    for _ in range(ATTEMPTS):
        trainer.reset_graph_counts()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        dev, host = _records(prof)
        fault = _fault(_replays(dev), trainer.graph_counts["replays"])
        if fault is None:
            out = summarize(dev, host, wall)
            out["profile_faults"] = faults
            return out
        faults.append(fault)
    raise RuntimeError(f"torch.profiler lost records of the traced call {ATTEMPTS} times: "
                       f"{faults}")
