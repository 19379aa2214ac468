"""Profiles of the policy optimizer's step on the card.

:func:`profile_steps` gives, for a function ``run(n)`` that runs an
optimization of n steps and waits for the card: host ms per step (no
profiler attached), device busy ms per step and device events per step
(``torch.profiler``'s kernel and copy records), the device's idle time
inside one replay of the graph (the gaps between its kernels), host CUDA
API calls per step (its records of the CUDA API, ``cuda*`` and
``cu*``: ``cudaLaunchKernel`` for each kernel issued one by one,
``cudaGraphLaunch`` for a graph replay), and the idle share 1 - busy /
host.  What a call does once (the probe rollout, the uncaptured warm-up
iteration and the capture of the CUDA graph) is left out: the host figure
is read from the optimizer's clock (``control.trainer.graph_counts``: the
seconds of its chunks of iterations over their iterations), the device
figures are differences of two runs, ``base`` steps and ``base`` + k steps.
A pair of windows whose records are evidently incomplete
(:func:`window_fault`) is profiled again, up to ``PROFILE_ATTEMPTS``
times: the profiler now and then returns a window short of records.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict

from ..control.trainer import GRAPH_WARMUP, graph_counts, reset_graph_counts

# a call of PolicyOptimizer.optimize with this many steps has captured its
# graph and replayed it once
GRAPH_BASE = GRAPH_WARMUP + 1
# a group of device records under one correlation id with at least this
# many records is a graph replay (one cudaGraphLaunch issues them all)
REPLAY_MIN = 100
# times profile_steps profiles a pair of windows before it gives up on
# their records
PROFILE_ATTEMPTS = 4

_RECORDS_CHECKED = []

# NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): float32 outside
# the tensor cores, and HBM
PEAK_FP32_FLOPS, PEAK_HBM_BYTES = 67e12, 3.35e12


def bound(work):
    """The least time the card could take for (bytes, flops), in ms, and
    what bounds it."""
    t_bytes, t_ops = work[0] / PEAK_HBM_BYTES, work[1] / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _kineto_events(prof):
    return prof.profiler.kineto_results.events()


def device_records(prof):
    """The device records (name, us) of a finished ``torch.profiler`` window,
    read from its raw kineto results: ``prof.events()`` would first build
    the host-side event tree, which takes seconds per 100K records (a
    profiled 4PMS step has ~26K kernels).  The first window read is also
    read through ``prof.events()`` and the two must hold the same records."""
    from torch.autograd import DeviceType

    out = [(e.name(), e.duration_ns() / 1e3) for e in _kineto_events(prof)
           if e.device_type() == DeviceType.CUDA
           and not getattr(e, "is_hidden_event", lambda: False)()]
    if not _RECORDS_CHECKED:
        parsed = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if sorted(n for n, _ in parsed) != sorted(n for n, _ in out) or not math.isclose(
                sum(t for _, t in parsed), sum(t for _, t in out), rel_tol=1e-6):
            raise RuntimeError(f"raw kineto records ({len(out)}) differ from the parsed "
                               f"events ({len(parsed)})")
        _RECORDS_CHECKED.append(len(out))
    return out


def _replay_groups(records) -> list:
    """The device records (correlation id, start ns, end ns) grouped by the
    correlation id of the launch that issued them: the spans of each group
    of at least ``REPLAY_MIN`` records (a graph replay)."""
    groups = defaultdict(list)
    for corr, start, end in records:
        groups[corr].append((start, end))
    return [spans for spans in groups.values() if len(spans) >= REPLAY_MIN]


def replay_gaps(records) -> list:
    """The device's idle time inside each graph replay, in us: ``records``
    (correlation id, start ns, end ns) of the device records of a window,
    grouped by the correlation id of the launch that issued them; for each
    group of at least ``REPLAY_MIN`` records, its span less the time its
    records cover."""
    out = []
    for spans in _replay_groups(records):
        spans.sort()
        covered, (lo, hi) = 0, spans[0]
        for start, end in spans[1:]:
            if start > hi:
                covered, lo = covered + hi - lo, start
            hi = max(hi, end)
        covered += hi - lo
        out.append((hi - spans[0][0] - covered) / 1e3)
    return out


def window_fault(base: dict, more: dict):
    """Why two profiled windows, of run(b) (``base``) and of a run of more
    steps (``more``), cannot be differenced, or None.  Each holds ``us``
    (device us in all), ``replays`` (the record count of each graph
    replay seen) and ``replays_run`` (the replays the optimizer counted).
    A window that lost records shows as device time that does not grow
    with the steps, replays of the one graph of differing sizes, or fewer
    replays seen than run."""
    if more["us"] <= base["us"]:
        return f"device us {more['us']:.1f} in the longer run against {base['us']:.1f}"
    sizes = base["replays"] + more["replays"]
    if sizes and min(sizes) != max(sizes):
        return f"graph replays of {sorted(set(sizes))} records"
    for w in (base, more) if sizes else ():
        if len(w["replays"]) != w["replays_run"]:
            return f"{len(w['replays'])} graph replays seen of {w['replays_run']} run"
    return None


def _replay_records(prof):
    from torch.autograd import DeviceType

    return [(e.correlation_id(), e.start_ns(), e.end_ns())
            for e in _kineto_events(prof) if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_hidden_event", lambda: False)()]


def api_calls(prof) -> Counter:
    """The host's CUDA API calls of a finished window (runtime ``cuda*``
    and low-level ``cu*``), by name (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...)."""
    from torch.autograd import DeviceType

    return Counter(e.name() for e in _kineto_events(prof)
                   if e.device_type() != DeviceType.CUDA and e.name().startswith("cu"))


def host_ms(run, steps, base=GRAPH_BASE, repeats=1):
    """Host ms per optimizer iteration of run(base + steps), ``repeats``
    times, from the optimizer's clock: the seconds of its chunks of replays
    of the graph over their replays if it captured one, else of its
    uncaptured iterations."""
    out = []
    for _ in range(repeats):
        reset_graph_counts()
        run(base + steps)
        kind = "replays" if graph_counts["replays"] else "uncaptured"
        out.append(1e3 * graph_counts[kind + "_s"] / graph_counts[kind])
    return out


def profile_steps(run, host_repeats=1, host_steps=10, window=5, base=GRAPH_BASE,
                  trace_path=None):
    """Profile the steps of ``run(n)``.  Host ms/step from :func:`host_ms`,
    unprofiled, averaged over ``host_repeats`` (each in ``host_runs``);
    device busy ms, device events and API calls per step, in all and by
    name (device us by kernel name too), from torch.profiler's
    records over run(base + window) minus run(base), over the ``steps`` the
    longer run added (fewer than ``window`` where the call stops early, as
    at a cap on its steps or an exit); ``gap_ms`` the least
    idle time inside one replay of the graph among the ``replays_seen``
    replays of run(base + window) (:func:`replay_gaps`; None uncaptured):
    the profiler stretches some replays by several ms; idle share 1 -
    busy / host.  ``base`` is ``GRAPH_BASE`` for the graphed step (its call
    captures within the base run) and may be 1 for the uncaptured one.
    ``trace_path``: a Chrome trace of the run(base + window) window."""
    from torch.profiler import ProfilerActivity, profile

    host_runs = host_ms(run, host_steps, base, host_repeats)
    host = sum(host_runs) / host_repeats

    def profiled(n, path=None):
        reset_graph_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(n)
        events = device_records(prof)
        if path:
            prof.export_chrome_trace(path)
        us = Counter()
        for name, t in events:
            us[name] += t
        records = _replay_records(prof)
        return dict(us_by=us, count_by=Counter(name for name, _ in events), api=api_calls(prof),
                    gaps=replay_gaps(records), us=us.total(),
                    replays=[len(spans) for spans in _replay_groups(records)],
                    replays_run=graph_counts["replays"],
                    steps=graph_counts["replays"] + graph_counts["uncaptured"])

    faults = []
    for _ in range(PROFILE_ATTEMPTS):
        w1, wn = profiled(base), profiled(base + window, trace_path)
        if wn["steps"] <= w1["steps"]:
            raise ValueError(f"run({base + window}) ran {wn['steps']} optimizer steps, "
                             f"run({base}) {w1['steps']}: no steps to profile")
        fault = window_fault(w1, wn)
        if fault is None:
            break
        faults.append(fault)
        print(f"[profile] window pair refused, profiling again: {fault}", flush=True)
    else:
        raise RuntimeError(f"torch.profiler returned incomplete windows of the optimizer "
                           f"steps {PROFILE_ATTEMPTS} times: {faults}")
    # the steps the longer run added (a call may stop before base + window)
    steps = wn["steps"] - w1["steps"]
    (us1, c1, a1), (usn, cn, an) = ((w["us_by"], w["count_by"], w["api"]) for w in (w1, wn))
    gaps = wn["gaps"]
    busy = 1e-3 * (usn.total() - us1.total()) / steps
    per = lambda a, b: {k: (a[k] - b[k]) / steps for k in a | b if a[k] != b[k]}
    largest_first = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))
    return dict(host_ms=host, host_runs=host_runs, busy_ms=busy,
                gap_ms=1e-3 * min(gaps) if gaps else None, replays_seen=len(gaps),
                events=(cn.total() - c1.total()) / steps, idle=1.0 - busy / host,
                api_calls=(an.total() - a1.total()) / steps, steps=steps, profile_faults=faults,
                events_by_kernel=largest_first(per(cn, c1)),
                us_by_kernel=largest_first(per(usn, us1)), api_by_name=largest_first(per(an, a1)))
