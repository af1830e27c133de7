"""Training driver of the PyTorch port: data, train step, AdamW,
checkpoints and preemption, for the dense, moe, vlm, ssm and hybrid
archs, on one CUDA card (the default) or, when asked, the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 8 --seq 1024            # the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 30 --batch 8 --seq 64 --device cpu

Mirrors the JAX package's ``launch/train.py``: the same flags, the same
synthetic data stream (``data/pipeline.py``), the same checkpoint files
and the same ``step …  loss=… lr=…`` lines.  ``--device`` defaults to
``cuda`` and raises without a card; nothing falls back to the CPU.  On
the card every norm runs its CUDA kernel forward and backward, while
attention and the SSD scan take their plain versions (the JAX training
path).  A mesh (``--mesh``) and the expert-parallel MoE (``--ep-moe``)
come with the scale-out slice of the port.
"""
from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step, restore)
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import model as model_lib
from repro_torch.train import optim
from repro_torch.train.step import build_train_step

#: what raises until its slice of the port lands (ROADMAP.md, Queue 1)
_LATER = "the scale-out slice of the PyTorch port"


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to train on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name}")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Train; returns what ran: the per-step ``losses``, ``lrs``,
    ``grad_norms``, ``step_s`` (host seconds, each step ending in a
    synchronise) and ``peak_bytes`` (the card's peak allocation after
    each step; 0 on the CPU), the ``start`` step, ``tokens_per_step``,
    the final ``params`` and ``opt`` state, ``cfg``, ``tc`` and the
    ``step_fn``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="none",
                    help="none | dxm spec like 2x4 (axes data,model); "
                         "only none is ported")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ep-moe", action="store_true",
                    help="expert-parallel MoE path (not ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=None,
                    help="the init generator's seed (default: "
                         "TrainConfig.seed)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch's depth to this many layers "
                         "(widths stay the arch's)")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(f"--mesh {args.mesh} comes with {_LATER} "
                                  f"(data/model-parallel training)")
    if args.ep_moe:
        raise NotImplementedError(f"--ep-moe comes with {_LATER} "
                                  f"(expert-parallel MoE)")
    dev = _device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=args.steps // 10,
                     total_steps=args.steps, checkpoint_every=args.ckpt_every,
                     checkpoint_dir=args.ckpt_dir)
    seed = tc.seed if args.seed is None else args.seed
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    dc = DataConfig()

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model_lib.init(cfg, gen, dev)
    opt = optim.init_opt_state(params, tc)
    step_fn = build_train_step(cfg, tc)

    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        tree, start = restore(
            args.ckpt_dir,
            {"params": params, "m": opt.m, "v": opt.v, "count": opt.count})
        params, opt = tree["params"], optim.OptState(
            m=tree["m"], v=tree["v"], count=tree["count"])
        print(f"resumed from step {start}")

    stop = {"flag": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: stop.__setitem__("flag", True))
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=tc.keep_checkpoints)
    out = {"losses": [], "lrs": [], "grad_norms": [], "step_s": [],
           "peak_bytes": [], "start": start,
           "tokens_per_step": args.batch * args.seq}
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     make_batch(cfg, shape, dc, i).items()}
            _sync(dev)
            ts = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            _sync(dev)
            out["step_s"].append(time.perf_counter() - ts)
            out["peak_bytes"].append(torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else 0)
            for key, name in (("losses", "total_loss"), ("lrs", "lr"),
                              ("grad_norms", "grad_norm")):
                out[key].append(float(metrics[name]))
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss={out['losses'][-1]:.4f} "
                      f"lr={out['lrs'][-1]:.2e}", flush=True)
            if (i + 1) % tc.checkpoint_every == 0 or stop["flag"]:
                ckpt.submit(i + 1, {"params": params, "m": opt.m,
                                    "v": opt.v, "count": opt.count})
            if stop["flag"]:
                print(f"preemption signal: checkpointed at {i + 1}")
                break
        ckpt.close()
    finally:
        signal.signal(signal.SIGTERM, previous)
    print(f"trained {len(out['losses'])} steps in {time.time()-t0:.1f}s")
    return dict(out, params=params, opt=opt, cfg=cfg, tc=tc,
                step_fn=step_fn)


if __name__ == "__main__":
    main()
