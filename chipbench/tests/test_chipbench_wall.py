"""The wall-following backend on a fake clock, driving the port's engine
at a smoke size on the CPU: the engine's clock follows the wall, nothing
joins before it is due, tokens carry their call's return time, and the
window's close ends the run."""
import numpy as np
import pytest
import torch

from chipbench.harness import cells, serve, weights
from chipbench.harness.wall import WallPagedBackend, WindowClosed
from chipbench.tests import smoke
from chipbench.traffic import requests as traffic

CHUNK_S, DECODE_S = 0.05, 0.02


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def sleep(self, dt):
        self.now += dt


def _setup(name, seconds, window):
    cell = smoke.cell(name)
    cfg = cells.model_config(cell.config)
    srv = cell.config["serving"]
    clock = FakeClock()
    from repro_torch.sched import ModelTarget, ResourceVector, get_estimator
    from repro_torch.serve import ServingDemand
    max_len = traffic.longest(cell.workload["requests"])
    demand = ServingDemand.from_estimate(get_estimator("kv-growth").estimate(
        ModelTarget(cfg, max_len, page_size=srv["page_size"])), max_len)
    budget = ResourceVector(hbm=demand.weights_gb + demand.kv_gb(
        srv["kv_pool_tokens"]))
    be = WallPagedBackend(
        cfg, params=weights.make(cfg, 5, "cpu"),
        num_pages=1 + srv["kv_pool_tokens"] // srv["page_size"],
        page_size=srv["page_size"], prefill_chunk=srv["prefill_chunk"],
        seed=5, device="cpu", clock=clock, sleep=clock.sleep)
    for attr, cost in (("_chunk", CHUNK_S), ("_decode", DECODE_S)):
        fn = getattr(be, attr)

        def timed(*a, _fn=fn, _cost=cost):
            clock.now += _cost
            return _fn(*a)
        setattr(be, attr, timed)
    specs = traffic.make(cell.workload["requests"], 5, 30.0,
                         cfg.vocab_size)
    reqs = serve._requests(specs)
    engine = serve._engine(reqs, demand, budget, srv["max_batch"], be)
    be.arm(window, seconds, srv["max_batch"])
    return clock, be, engine, reqs


def test_engine_clock_follows_the_wall_and_joins_wait():
    clock, be, engine, reqs = _setup(smoke.OPEN, 3.0,
                                     {"opens": "lead", "lead_s": 0.5})
    with pytest.raises(WindowClosed):
        engine.run()
    assert be.window == pytest.approx((be.origin + 0.5, be.origin + 3.5))
    assert clock.now >= be.window[1]
    # the engine's clock equals the wall at every step's end
    drift = (be.step_ends[-1] - be.origin) - engine._clocks[0]
    assert abs(drift) < 1e-9
    assert max(be.lags) <= CHUNK_S + DECODE_S + 1e-9
    # nobody joins before being due; everybody due long enough ago has
    for r in reqs:
        if r.rid in be.joined:
            assert be.joined[r.rid] >= be.origin + r.arrival - 1e-9
        elif be.origin + r.arrival < be.window[1] - 1.0:
            pytest.fail(f"request {r.rid} due at {r.arrival} never joined")
    # each token is stamped with its call's return, in order
    ends = {c.t1 for c in be.calls}
    for rid, ts in be.stamps.items():
        assert all(t in ends for t in ts)
        assert ts == sorted(ts)
        assert len(ts) == len(next(r for r in reqs if r.rid == rid).tokens)


def test_backlog_window_opens_when_rows_full():
    clock, be, engine, reqs = _setup(smoke.BATCH, 2.0, {"opens": "rows_full"})
    with pytest.raises(WindowClosed):
        engine.run()
    first = be.calls[0]
    assert first.kind == "prefill" and len(first.rows) == be.max_rows
    assert be.window[0] == first.t1
    assert be.window[1] - be.window[0] == 2.0


def test_idle_engine_waits_on_the_wall():
    """An idle jump costs the engine nothing: the join waits for the
    request, and the step after it ends at the wall."""
    clock, be, engine, reqs = _setup(smoke.OPEN, 30.0,
                                     {"opens": "lead", "lead_s": 0.0})
    gaps = np.diff([r.arrival for r in reqs])
    assert gaps.max() > CHUNK_S * 10       # the stream has idle spells
    with pytest.raises(WindowClosed):
        engine.run()
    calls = [c for c in be.calls if c.kind == "prefill"]
    for r in reqs[:5]:
        first = next(c for c in calls if c.t0 >= be.joined[r.rid] - 1e-9)
        assert first.t0 >= be.origin + r.arrival - 1e-9
