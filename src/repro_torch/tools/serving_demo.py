"""Memory-aware continuous batching: the paper's technique as a
first-class serving feature. The engine calibrates a memory function for
the model's serving footprint (weights + KV vs active requests), then
uses its INVERSE — re-evaluated at EVERY decode step — to keep the
largest request batch that fits the device-memory budget: new prefills
join as soon as their KV fits, finished requests free their slots
immediately, and over-budget KV growth evicts the lowest-priority
request (requeued, recomputed later).  Exactly the paper's "how many
data items under a memory budget" loop, asked once per decode step
instead of once per wave.

    python -m repro_torch.tools.serving_demo --requests 12          # the card
    python -m repro_torch.tools.serving_demo --device cpu

The same flags and printed summary as the JAX package's
``examples/serving_demo.py``, plus ``--device`` (the card by default; it
raises without one): qwen3-0.6b's smoke config served by
``TorchBackend``, whose prefill runs the flash kernel and each decode
step the dense decode kernel on the card, every norm its RMSNorm kernel.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.sched import ModelTarget, ResourceVector, get_estimator
from repro_torch.serve import Engine, Request, ServingDemand, TorchBackend
from repro_torch.tools.common import device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--budget-gb", type=float, default=0.0004)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--mode", default="continuous",
                    choices=("continuous", "wave"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def requests(n: int, decode_steps: int) -> list:
    """The demo's open queue: ``n`` requests of 8-23 prompt tokens and
    up to ``decode_steps`` new ones, all arriving at 0."""
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt_len=int(rng.integers(8, 24)),
                    max_new_tokens=int(rng.integers(
                        max(decode_steps // 2, 1), decode_steps + 1)),
                    arrival=0.0)
            for i in range(n)]


def serve(args, cfg, params=None) -> dict:
    """The demo over ``cfg`` (``params``: the backend's weights, else
    drawn from its seed).  Returns the engine's ``summary``, the
    ``engine`` and its ``requests``."""
    dev = device(args.device)

    # --- the paper's runtime path, applied to serving capacity ---------
    # the kv-growth estimator two-point-calibrates footprint-vs-batch
    # (cached per (config, max_len) key — a second construction reuses
    # the fit)
    estimate = get_estimator("kv-growth").estimate(
        ModelTarget(cfg, args.max_len))
    fn = estimate.primary_fn
    demand = ServingDemand.from_estimate(estimate, args.max_len)
    print(f"footprint(batch) ~= {fn.m:.4f} + {fn.b:.5f} GB/slot "
          f"(calibrated at batch 2,4) -> {demand.kv_gb_per_token * 2**20:.2f} "
          f"KiB KV per token per request")
    whole = int(fn.inverse(args.budget_gb))
    print(f"HBM budget {args.budget_gb} GB -> {whole} full-length "
          f"requests fit; continuous mode packs more by admitting "
          f"against LIVE context lengths")

    # --- serve an open queue through the engine -------------------------
    reqs = requests(args.requests, args.decode_steps)
    engine = Engine(reqs, demand, ResourceVector(hbm=args.budget_gb),
                    TorchBackend(cfg, params=params, max_len=args.max_len,
                                 device=dev),
                    mode=args.mode, max_batch=16)
    summary = engine.run()
    print(engine.metrics.format_summary(summary))
    if summary["forced_steps"]:
        # the engine keeps making progress (min batch 1) even when the
        # weights alone exceed the budget — the decision says so
        print(f"note: {summary['forced_steps']} forced step(s) — a "
              f"single request exceeds the budget; serving anyway")
    joins = sum(1 for d in engine.metrics.steps if d.admitted)
    sample = next(r for r in reqs if r.tokens)
    print(f"served {summary['completed']} requests across "
          f"{summary['steps']} steps ({joins} join points, "
          f"{summary['preemptions']} preemptions); sample continuation "
          f"rid={sample.rid}: {sample.tokens[:6]}")
    return dict(summary=summary, engine=engine, requests=reqs, joins=joins)


def main(argv=None) -> dict:
    return serve(parser().parse_args(argv),
                 get_config("qwen3-0.6b", smoke=True))


if __name__ == "__main__":
    main()
