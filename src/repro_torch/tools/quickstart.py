"""Quickstart: train a ~100M-param LM end-to-end on synthetic data.

Exercises the port's training substrate: model build, AdamW, the
deterministic data pipeline, checkpointing (async) and resume.

    python -m repro_torch.tools.quickstart --steps 200            # the card
    python -m repro_torch.tools.quickstart --steps 20 --device cpu
    python -m repro_torch.tools.quickstart --steps 400 --resume

The same config, flags and printed lines as the JAX package's
``examples/quickstart.py``, plus ``--device`` (the card by default; it
raises without one) and ``--ckpt-every``.  On the card every norm runs
its RMSNorm kernel forward and backward.  JAX's step donates the params
and optimizer state to its outputs; the eager step here makes new
tensors each step.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step, restore)
from repro_torch.configs import TrainConfig
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import model
from repro_torch.tools.common import device
from repro_torch.train import optim
from repro_torch.train.step import build_train_step
from repro_torch.utils.tree import tree_leaves, tree_map


def quickstart_config() -> ModelConfig:
    """~100M params: 12L, d=512, 8H (kv=4), ff=2048, 32k vocab."""
    return ModelConfig(
        name="quickstart-100m", family="dense", num_layers=12, d_model=512,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32_000, use_qk_norm=True,
        param_dtype="float32", compute_dtype="float32", remat="none")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def train(args, cfg: ModelConfig, params=None) -> dict:
    """The quickstart loop over ``cfg`` (``params``: the initial
    parameters, else drawn from seed 0 on the device).  Returns the
    per-step ``losses``, the ``start`` step and the final ``params`` and
    ``opt`` state."""
    dev = device(args.device)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=20,
                     total_steps=args.steps,
                     checkpoint_every=args.ckpt_every,
                     checkpoint_dir=args.ckpt_dir)
    shape = ShapeConfig("quickstart", "train", args.seq, args.batch)
    dc = DataConfig(kind="lm_synthetic")

    if params is None:
        params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    else:
        params = tree_map(lambda t: t.to(dev), params)
    opt = optim.init_opt_state(params, tc)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {n_params/1e6:.1f}M params")

    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        tree, start = restore(args.ckpt_dir,
                              {"params": params, "m": opt.m, "v": opt.v,
                               "count": opt.count})
        params = tree["params"]
        opt = optim.OptState(m=tree["m"], v=tree["v"], count=tree["count"])
        print(f"resumed from step {start}")

    step_fn = build_train_step(cfg, tc)
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=tc.keep_checkpoints)
    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 make_batch(cfg, shape, dc, i).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["total_loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            tps = (i - start + 1) * args.batch * args.seq \
                / max(time.time() - t0, 1e-9)
            print(f"step {i:4d}  loss={losses[-1]:.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}  "
                  f"lr={float(metrics['lr']):.2e}  tok/s={tps:,.0f}")
        if (i + 1) % tc.checkpoint_every == 0:
            ckpt.submit(i + 1, {"params": params, "m": opt.m, "v": opt.v,
                                "count": opt.count})
    ckpt.close()
    print(f"done in {time.time()-t0:.1f}s; checkpoints in {args.ckpt_dir}")
    return dict(losses=losses, start=start, params=params, opt=opt)


def main(argv=None) -> dict:
    return train(parser().parse_args(argv), quickstart_config())


if __name__ == "__main__":
    main()
