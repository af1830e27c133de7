"""One run of a training cell: the port's train step
(``build_train_step``, bf16 parameters, fp32 AdamW moments, each layer
recomputed in the backward), one object built in set-up, driven from the
seed through its first three steps (which the check reads and which warm
every shape), then through the window; the plain reference follows the
first three steps once the window has closed."""
from __future__ import annotations

import gc
import sys
import time

import torch

from chipbench import archs
from chipbench.harness import weights
from chipbench.harness.record import TrainRecord
from chipbench.reference import train as ref_train
from chipbench.traffic.train_batches import Batches

CHECKED_STEPS = 3


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _norms(tree) -> dict:
    return {k: float(v.float().norm())
            for k, v in ref_train.leaves(tree).items()}


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float = None, fault=None, log=sys.stderr):
    """-> (record, readings).  ``fault`` (tests) wraps the step."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step
    from chipbench.harness.counters import Counters
    from chipbench.harness.profiling import Slice

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    arch = archs.for_config(cell.config)
    cfg = arch.model_config(cell.config, training=True)
    wl = cell.workload
    hp = wl["optimizer"]
    tc = TrainConfig(learning_rate=hp["learning_rate"],
                     warmup_steps=hp["warmup_steps"],
                     total_steps=hp["total_steps"],
                     weight_decay=hp["weight_decay"], beta1=hp["beta1"],
                     beta2=hp["beta2"], eps=hp["eps"],
                     grad_clip=hp["grad_clip"],
                     adam_dtype=cell.config["training"]["adam_dtype"])
    data = Batches(wl["batches"], seed, cfg.vocab_size, device)
    params = weights.make(cfg, seed, device)
    opt = optim.init_opt_state(params, tc)
    step = build_train_step(cfg, tc)
    if fault is not None:
        step = fault(step)

    # set-up: the first three steps through the window's own call
    first = [data.next() for _ in range(CHECKED_STEPS)]
    losses = []
    start = params
    for i, batch in enumerate(first):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["total_loss"]))
        if i == 0:
            b1 = tc.beta1
            grad = {k: float(v.float().norm()) / (1 - b1)
                    for k, v in ref_train.leaves(opt.m).items()}
    change = {k: float((v.float() - s.float()).norm())
              for (k, v), s in zip(ref_train.leaves(params).items(),
                                   ref_train.leaves(start).values())}
    del start
    prof = Slice() if trace else None
    counters = Counters() if cuda else None
    if prof is not None:
        Slice.warm()
    _sync(device)

    # the window
    w0 = time.perf_counter()
    w1 = w0 + seconds
    ends, launches, profiled = [], {}, 0
    profile_s = min(float(wl.get("profile_s", 4.0)), seconds / 2)
    while True:
        if prof is not None and prof.prof is None and \
                time.perf_counter() >= w1 - profile_s:
            prof.start()
            before = counters.snapshot() if counters else {}
        with torch.profiler.record_function("chipbench/feed"):
            batch = data.next()
        with torch.profiler.record_function("chipbench/train_step"):
            params, opt, m = step(params, opt, batch)
            _sync(device)
        t = time.perf_counter()
        ends.append(t)
        if prof is not None and prof.running:
            profiled += 1
        if t >= w1:
            break
    if prof is not None and prof.running:
        prof.stop()
        launches = counters.since(before) if counters else {}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    record = TrainRecord(
        cfg=cfg, arch=arch, window=(w0, w1), step_ends=ends,
        tokens_per_step=data.tokens_per_step, batch=data.batch,
        seq=data.seq, profile=prof.summary() if prof is not None
        and prof.prof else None, profiled_launches=launches,
        profiled_steps=profiled)
    last_loss = float(m["total_loss"])
    del params, opt, m, batch, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference follows the first three steps
    t_ref = time.perf_counter()
    ref = ref_train.run(weights.make(cfg, seed, device), arch.reference,
                        arch.reference.Dims.of(cell.config), first, hp)
    from chipbench.reference.compare import train_numbers
    numbers = train_numbers({"losses": losses, "grad": grad,
                             "change": change}, ref)
    print(f"chipbench: losses {losses} (last step {last_loss:.6f}); "
          f"reference {ref['losses']}, unclipped gradient norm "
          f"{ref['grad_global']:.6f}; reference "
          f"{time.perf_counter() - t_ref:.1f} s", file=log)
    return record, {"numbers": numbers, "memory_peak_bytes": peak,
                    "setup_s": w0 - t_start}
