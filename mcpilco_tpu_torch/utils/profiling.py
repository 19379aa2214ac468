"""Profiles of the policy optimizer's step on the card.

:func:`profile_steps` gives, for a function ``run(n)`` that runs an
optimization of n steps and waits for the card: host ms per step (no
profiler attached), device busy ms per step and device events per step
(``torch.profiler``'s kernel and copy records), host CUDA API calls per step
(its records of the CUDA API, ``cuda*`` and ``cu*``: ``cudaLaunchKernel`` for
each kernel issued one by one, ``cudaGraphLaunch`` for a graph replay), and
the idle share 1 - busy / host.  What a call does once (the probe rollout, the uncaptured
warm-up iteration and the capture of the CUDA graph) is left out: the host
figure is read from the optimizer's per-iteration clock
(``control.trainer.graph_counts``), the device figures are differences of
two runs, ``base`` steps and ``base`` + k steps.
"""

from __future__ import annotations

import math
from collections import Counter

from ..control.trainer import GRAPH_WARMUP, graph_counts, reset_graph_counts

# a call of PolicyOptimizer.optimize with this many steps has captured its
# graph and replayed it once
GRAPH_BASE = GRAPH_WARMUP + 1

_RECORDS_CHECKED = []


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


def api_calls(prof) -> Counter:
    """The host's CUDA API calls of a finished window (runtime ``cuda*``
    and low-level ``cu*``), by name (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...)."""
    from torch.autograd import DeviceType

    return Counter(e.name() for e in _kineto_events(prof)
                   if e.device_type() != DeviceType.CUDA and e.name().startswith("cu"))


def host_ms(run, steps, base=GRAPH_BASE, repeats=1):
    """Host ms per optimizer iteration of run(base + steps), ``repeats``
    times, from the optimizer's per-iteration clock: the mean of its
    replays of the graph if it captured one, else of its uncaptured
    iterations."""
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
    records over run(base + window) minus run(base); idle share 1 - busy /
    host.  ``base`` is ``GRAPH_BASE`` for the graphed step (its call
    captures within the base run) and may be 1 for the uncaptured one.
    ``trace_path``: a Chrome trace of the run(base + window) window."""
    from torch.profiler import ProfilerActivity, profile

    host_runs = host_ms(run, host_steps, base, host_repeats)
    host = sum(host_runs) / host_repeats

    def profiled(n, path=None):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(n)
        events = device_records(prof)
        if path:
            prof.export_chrome_trace(path)
        us = Counter()
        for name, t in events:
            us[name] += t
        return us, Counter(name for name, _ in events), api_calls(prof)

    (us1, c1, a1), (usn, cn, an) = profiled(base), profiled(base + window, trace_path)
    busy = 1e-3 * (usn.total() - us1.total()) / window
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time for the optimizer steps")
    per = lambda a, b: {k: (a[k] - b[k]) / window for k in a | b if a[k] != b[k]}
    largest_first = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))
    return dict(host_ms=host, host_runs=host_runs, busy_ms=busy,
                events=(cn.total() - c1.total()) / window, idle=1.0 - busy / host,
                api_calls=(an.total() - a1.total()) / window,
                events_by_kernel=largest_first(per(cn, c1)),
                us_by_kernel=largest_first(per(usn, us1)), api_by_name=largest_first(per(an, a1)))
