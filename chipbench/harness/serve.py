"""One run of a serving cell: the port's engine over the wall-clock
paged backend, wired as the serving CLI wires it (the kv-growth
estimator, its ``ServingDemand``, an hbm budget, one replica, fcfs),
then the check of a sample of the finished requests against the plain
reference."""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from chipbench import archs
from chipbench.harness import weights
from chipbench.harness.record import ServeRecord
from chipbench.harness.wall import WallPagedBackend, WindowClosed
from chipbench.reference.compare import serve_numbers
from chipbench.traffic import requests as traffic


def _engine(reqs, demand, budget, max_batch, backend):
    from repro_torch.serve import Engine
    return Engine(reqs, demand, budget, placement="fcfs",
                  max_batch=max_batch, backends=[backend])


def _requests(specs):
    from repro_torch.serve import Request
    return [Request(rid=s.rid, prompt_len=len(s.prompt),
                    max_new_tokens=s.max_new, arrival=s.due,
                    prompt=list(s.prompt)) for s in specs]


def warm_up(backend, demand, budget, max_batch: int, chunk: int,
            vocab: int) -> None:
    """Every shape the window uses: the engine's first step joins
    ``max_batch`` rows at once (so the row capacity reaches its last
    bucket, where it stays), and their two chunks each and their last
    token run the chunk call, a step with both calls, and the decode
    call."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt_len=chunk + 1, max_new_tokens=2,
                    prompt=rng.integers(traffic.FIRST_TOKEN, vocab,
                                        chunk + 1).tolist())
            for i in range(max_batch)]
    _engine(reqs, demand, budget, max_batch, backend).run()
    if backend._cap < max_batch:
        raise RuntimeError(f"warm-up reached {backend._cap} rows of "
                           f"{max_batch}")


def sample(served, seed: int, tokens: int, most: int):
    """The longest of the requests that were served tokens (prompt and
    tokens), then others drawn from the seed, until ``tokens`` served
    tokens or ``most`` requests."""
    if not served:
        return []
    order = sorted(served, key=lambda r: (-(r.prompt_len + len(r.tokens)),
                                          r.rid))
    picked = [order[0]]
    rest = order[1:]
    rng = np.random.default_rng([int(seed), 13])
    for i in rng.permutation(len(rest)):
        if (sum(len(r.tokens) for r in picked) >= tokens
                or len(picked) >= most):
            break
        picked.append(rest[i])
    return picked


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float = None, tamper=None, log=sys.stderr):
    """-> (record, readings): the run's record and what the check read
    ({"numbers", "memory_peak_bytes", "setup_s", "sample", "gaps"}:
    ``gaps`` one tensor for each sampled request)."""
    from repro_torch.sched import ModelTarget, ResourceVector, get_estimator
    from repro_torch.serve import ServingDemand
    from chipbench.harness.counters import Counters
    from chipbench.harness.profiling import Slice

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    arch = archs.for_config(cell.config)
    cfg = arch.model_config(cell.config)
    srv, wl = cell.config["serving"], cell.workload
    page, chunk = int(srv["page_size"]), int(srv["prefill_chunk"])
    max_batch, pool = int(srv["max_batch"]), int(srv["kv_pool_tokens"])
    params = weights.make(cfg, seed, device)
    window = wl["window"]
    horizon = float(window.get("lead_s", 0.0)) + seconds + 1.0
    specs = traffic.make(wl["requests"], seed, horizon, cfg.vocab_size)
    print(f"chipbench: traffic {traffic.summary(specs)}", file=log)

    max_len = traffic.longest(wl["requests"])
    estimate = get_estimator("kv-growth").estimate(
        ModelTarget(cfg, max_len, page_size=page))
    demand = ServingDemand.from_estimate(estimate, max_len)
    budget = ResourceVector(hbm=demand.weights_gb + demand.kv_gb(pool))
    backend = WallPagedBackend(
        cfg, params=params, num_pages=1 + pool // page, page_size=page,
        prefill_chunk=chunk, seed=seed, device=device,
        counters=Counters() if cuda else None)
    warm_up(backend, demand, budget, max_batch, chunk, cfg.vocab_size)
    backend.tamper = tamper
    prof = Slice() if trace else None
    if prof is not None:
        Slice.warm()
        profile_s = min(float(wl.get("profile_s", 4.0)), seconds / 2)

        def start_profile(be):
            if (prof.prof is None and be.window is not None
                    and be.clock() >= be.window[1] - profile_s):
                prof.start()
                rec_span[0] = be.clock()
        backend.before_call = start_profile
    rec_span = [0.0, 0.0]
    if cuda:
        torch.cuda.synchronize()
    reqs = _requests(specs)
    engine = _engine(reqs, demand, budget, max_batch, backend)
    backend.arm(window, seconds, max_batch)
    try:
        engine.run()
    except WindowClosed:
        pass
    if backend.window is None:
        raise RuntimeError("the window never opened")
    if prof is not None and prof.running:
        prof.stop()
        rec_span[1] = backend.clock()
    w0, w1 = backend.window
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    drift = ((backend.step_ends[-1] - backend.origin) - engine._clocks[0]
             if backend.step_ends else 0.0)
    lags = np.array(backend.lags or [0.0])
    print(f"chipbench: engine clock behind the wall by {drift:.6f} s at "
          f"the last step; at joins median {np.median(lags):.6f} s, max "
          f"{lags.max():.6f} s (the open loop's requests are released "
          f"that late)", file=log)
    record = ServeRecord(
        cfg=cfg, arch=arch, window=(w0, w1), calls=backend.calls,
        stamps=backend.stamps,
        due={r.rid: backend.origin + r.arrival for r in reqs},
        joined=backend.joined, cap=backend._cap, chunk=chunk, page=page,
        profile=prof.summary() if prof is not None and prof.prof else None,
        profiled=tuple(rec_span))

    if record.window[1] > record.window[0]:
        from chipbench.harness.endtoend import tails
        print(f"chipbench: {tails(record)}", file=log)
    chk = wl["check"]
    # every request that was served tokens, finished or in flight: at
    # these sizes a chat request outlives the window
    picked = sample([r for r in reqs if r.tokens], seed,
                    int(chk["sample_tokens"]), int(chk["most_requests"]))
    prompts = [list(r.prompt) for r in picked]
    served = [list(r.tokens) for r in picked]
    del engine, backend, reqs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = arch.reference
    gaps = (ref.served_gaps(params, ref.Dims.of(cell.config), prompts,
                            served, device) if picked else [])
    numbers = serve_numbers(gaps, int(chk.get("request_min_tokens", 1)))
    print(f"chipbench: reference over {len(picked)} requests "
          f"({sum(r.done for r in picked)} finished), "
          f"{sum(len(s) for s in served)} served tokens, "
          f"{time.perf_counter() - t_ref:.1f} s", file=log)
    return record, {"numbers": numbers,
                    "memory_peak_bytes": peak, "setup_s": w0 - t_start,
                    "sample": {"prompts": prompts, "served": served,
                               "rids": [r.rid for r in picked]},
                    "gaps": gaps}
