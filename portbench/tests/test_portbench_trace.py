"""The traced call's summary and the per-layer readers, on synthetic
records."""

import pytest

from portbench import harness, trace


def _replay(corr, t0, n=120, kernel="k", gap=10):
    """n device records of 100 ns with ``gap`` ns between them."""
    return [(kernel if i else "void k1_forward<6, true>(Args)", t0 + i * (100 + gap),
             t0 + i * (100 + gap) + 100, corr) for i in range(n)]


def test_summary_of_replays():
    dev = _replay(1, 0) + _replay(2, 100_000) + [("Memcpy HtoD", 150_000, 150_050, 3)]
    host = [("cudaGraphLaunch", 0, 50), ("cudaEventSynchronize", 20_000, 90_000)]
    s = trace.summarize(dev, host, wall_s=1e-3)
    assert s["replays"] == 2 and s["steady_kernels"] == 240
    span = (100_000 + 119 * 110 + 100) / 1e9
    assert s["steady_s"] == pytest.approx(span)
    assert s["steady_busy_s"] == pytest.approx(240 * 100 / 1e9)
    assert s["k1_launches"] == 2 and s["k1_s"] == pytest.approx(200 / 1e9)
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0][0] == "cudaEventSynchronize" and len(gaps) <= trace.GAPS
    assert s["breakdown"]["device_ops"][0][0] == "k"


def test_lost_records_are_refused():
    assert trace._fault([[(0, 1)] * 120, [(0, 1)] * 119], 2) is not None
    assert trace._fault([[(0, 1)] * 120], 2) is not None
    assert trace._fault([[(0, 1)] * 120] * 2, 2) is None


def _ctx(records=None, cuda=True, cell="cartpole.opt"):
    c, cfg = harness.load_cell(cell)
    return dict(cell=c, cfg=cfg, info={"M": 384}, cuda=cuda, records=records, calls=2,
                window_s=10.0, lane_steps=300, lane_steps_per_s=30.0,
                counters={"graph": {"uncaptured": 2, "captures": 2, "replays": 298,
                                    "captures_s": 1.0, "replays_s": 8.5, "reads": 4,
                                    "wasted": 0, "uncaptured_s": 0.5}})


def test_readers():
    mods = {m.NAME: m for m in harness.metric_modules()}
    assert mods["opt.capture_s"].read(_ctx()) == 0.5
    assert mods["opt.outside_replay_share"].read(_ctx()) == pytest.approx(15.0)
    assert mods["farm.lane_occupancy"].read(_ctx()) == pytest.approx(100.0)
    assert mods["step_mfu"].read(_ctx()) == pytest.approx(100 * 44.60112e9 * 30 / 67e12)
    # off the card, or without a traced call, the device's readers find nothing
    assert mods["step_mfu"].read(_ctx(cuda=False)) is None
    for name in ("device.idle_share", "device.kernels_per_iter", "k1_roofline", "k2_roofline"):
        assert mods[name].read(_ctx()) is None
    rec = dict(steady_s=1.0, steady_busy_s=0.05, steady_kernels=2000, replays=2, k1_s=1e-4,
               k1_launches=4, k2_s=0.0, k2_launches=0)
    # busy 25 ms a replay against the untraced window's 8.5 s over 298 replays
    idle = 100 * (1 - 0.025 / (8.5 / 298))
    assert mods["device.idle_share"].read(_ctx(rec)) == pytest.approx(idle)
    assert mods["device.kernels_per_iter"].read(_ctx(rec)) == 1000
    assert mods["k2_roofline"].read(_ctx(rec)) is None
    share = mods["k1_roofline"].read(_ctx(rec))
    assert 0 < share < 100
    # Furuta's plain predict launches no K1/K2: nothing to read
    assert mods["k1_roofline"].read(_ctx(rec, cell="furuta.opt")) is None
