"""Training driver of the PyTorch port: data, train step, AdamW,
checkpoints and preemption, for the dense, moe, vlm, ssm and hybrid
archs, on one CUDA card (the default) or, when asked, the CPU; with
``--mesh DxM`` on a (data, model) mesh of D·M ranks, one process each.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 8 --seq 1024            # the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 30 --batch 8 --seq 64 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3-moe-30b-a3b --smoke --mesh 2x2 --ep-moe --device cpu

Mirrors the JAX package's ``launch/train.py``: the same flags, the same
synthetic data stream (``data/pipeline.py``), the same checkpoint files
and the same ``step …  loss=… lr=…`` lines.  ``--device`` defaults to
``cuda`` and raises without a card; nothing falls back to the CPU.  On
the card every norm runs its CUDA kernel forward and backward, while
attention and the SSD scan take their plain versions (the JAX training
path).

``--mesh DxM`` trains with the sharded step of ``train/sharded.py``
(parameters, ZeRO-1 moments and batch placed by ``launch/sharding.py``'s
rules) over the default process group: the one the caller has set up,
else one from ``torchrun``'s environment, else one rank of its own
(``--mesh 1x1``).  Its backend is gloo with ``--device cpu``; on the
card a rank takes card ``LOCAL_RANK % device_count``, with NCCL where
every local rank has a card of its own and gloo where ranks share one
(``torchrun --nproc-per-node 2 ... --mesh 1x2`` on one card); a failed
init raises.  On a mesh with a 'model' axis the dense blocks compute on
their shards (``models/tp.py``).  ``--ep-moe`` runs the MoE layers
expert-parallel on the mesh (``models/moe_ep.py``); it needs
``--mesh``.  ``--resume`` restores the checkpoint onto the mesh
(``restore(..., shardings=)``), whatever mesh, or none, wrote it; rank 0
writes the checkpoints.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step, restore)
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import sharding as shd
from repro_torch.models import model as model_lib
from repro_torch.train import optim
from repro_torch.train.sharded import (build_sharded_train_step,
                                       gather_state, shard_state)
from repro_torch.train.step import build_train_step
from repro_torch.utils.tree import flatten_with_paths


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to train on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name}")
    return dev


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh(spec: str, dev: torch.device):
    """(the ``DeviceMesh`` of ``--mesh DxM`` on axes (data, model), the
    rank's device, whether this call set up the process group).  Local
    rank r takes card ``r % device_count``: NCCL where every local rank
    has a card of its own, gloo where ranks share one (NCCL refuses two
    ranks on one card); the run prints which."""
    D, M = (int(x) for x in spec.split("x"))
    owned = not dist.is_initialized()
    shared = False
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda",
                           int(os.environ.get("LOCAL_RANK", 0)) % cards)
        torch.cuda.set_device(dev)
        shared = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get(
            "WORLD_SIZE", 1))) > cards
    if owned:
        backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                rank=0, world_size=1)
    try:
        if dist.get_world_size() != D * M:
            raise ValueError(f"--mesh {spec} needs {D * M} ranks; the "
                             f"process group has {dist.get_world_size()}")
        from torch.distributed.device_mesh import init_device_mesh
        backend = dist.get_backend()
        mesh = init_device_mesh(dev.type, (D, M),
                                mesh_dim_names=("data", "model"))
    except BaseException:
        if owned:
            dist.destroy_process_group()
        raise
    if dist.get_rank() == 0:
        print(f"mesh {spec}: {dist.get_world_size()} ranks, backend "
              f"{backend}, rank 0 on {dev}"
              + (" (the local ranks share the cards)" if shared else ""),
              flush=True)
    return mesh, dev, owned


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Train; returns what ran: the per-step ``losses``, ``lrs``,
    ``grad_norms``, ``step_s`` (host seconds, each step ending in a
    synchronise) and ``peak_bytes`` (the card's peak allocation after
    each step; 0 on the CPU), the ``start`` step, ``tokens_per_step``,
    the final ``params`` and ``opt`` state (DTensors on a mesh),
    ``cfg``, ``tc``, the ``step_fn`` and the ``mesh`` (or None)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="none",
                    help="none | dxm spec like 2x4 (axes data,model): one "
                         "process per rank")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ep-moe", action="store_true",
                    help="expert-parallel MoE path (needs --mesh)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=None,
                    help="the init generator's seed (default: "
                         "TrainConfig.seed)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch's depth to this many layers "
                         "(widths stay the arch's)")
    ap.add_argument("--dtype", default=None,
                    help="params and compute in this dtype (e.g. float32; "
                         "default: the arch's)")
    args = ap.parse_args(argv)
    if args.ep_moe and args.mesh == "none":
        raise ValueError("--ep-moe runs on a mesh: pass --mesh DxM")
    dev = _device(args.device)
    mesh, owned = None, False
    if args.mesh != "none":
        mesh, dev, owned = _mesh(args.mesh, dev)
    try:
        return _train(args, dev, mesh)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, dev: torch.device, mesh) -> dict:
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    if args.dtype is not None:
        cfg = cfg.replace(param_dtype=args.dtype, compute_dtype=args.dtype)
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=args.steps // 10,
                     total_steps=args.steps, checkpoint_every=args.ckpt_every,
                     checkpoint_dir=args.ckpt_dir)
    seed = tc.seed if args.seed is None else args.seed
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    dc = DataConfig()

    def batch_at(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in
                make_batch(cfg, shape, dc, i).items()}

    # every rank draws the same whole state from the seed, then keeps its
    # shards of it
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model_lib.init(cfg, gen, dev)
    opt = optim.init_opt_state(params, tc)
    shardings = None
    if mesh is None:
        step_fn = build_train_step(cfg, tc)
    else:
        sh = shd.train_shardings(cfg, mesh, params, opt, batch_at(0), tc)
        params, opt = shard_state(params, opt, sh)
        step_fn = build_sharded_train_step(
            cfg, tc, sh, ep=args.ep_moe and cfg.family == "moe")
        shardings = {"params": sh["params"], "m": sh["opt"].m,
                     "v": sh["opt"].v, "count": sh["opt"].count}
    lead = mesh is None or dist.get_rank() == 0
    if lead and mesh is not None and shd.model_axis_size(mesh) > 1:
        split = step_fn.tp_leaves[0]
        whole = [p for p, _ in flatten_with_paths(params) if p not in split
                 and p.rsplit("/", 1)[-1] in shd.TP_NAMES]
        print(f"tensor parallel over 'model': {len(split)} leaves split"
              + (f"; computed whole: {', '.join(whole)}" if whole else ""),
              flush=True)

    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        tree, start = restore(
            args.ckpt_dir,
            {"params": params, "m": opt.m, "v": opt.v, "count": opt.count},
            shardings=shardings)
        params, opt = tree["params"], optim.OptState(
            m=tree["m"], v=tree["v"], count=tree["count"])
        if lead:
            print(f"resumed from step {start}")

    stop = {"flag": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: stop.__setitem__("flag", True))
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=tc.keep_checkpoints) \
        if lead else None
    out = {"losses": [], "lrs": [], "grad_norms": [], "step_s": [],
           "peak_bytes": [], "start": start,
           "tokens_per_step": args.batch * args.seq}
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            batch = batch_at(i)
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
            if lead and (i % 10 == 0 or i == args.steps - 1):
                print(f"step {i:5d} loss={out['losses'][-1]:.4f} "
                      f"lr={out['lrs'][-1]:.2e}", flush=True)
            if mesh is not None:
                # a signal to any rank stops every rank at the same step
                flag = torch.tensor(float(stop["flag"]), device=dev)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                stop["flag"] = bool(flag.item())
            if (i + 1) % tc.checkpoint_every == 0 or stop["flag"]:
                tree = gather_state({"params": params, "m": opt.m,
                                     "v": opt.v, "count": opt.count})
                if lead:
                    ckpt.submit(i + 1, tree)
                del tree
            if stop["flag"]:
                if lead:
                    print(f"preemption signal: checkpointed at {i + 1}")
                break
        if lead:
            ckpt.close()
    finally:
        signal.signal(signal.SIGTERM, previous)
    if lead:
        print(f"trained {len(out['losses'])} steps in "
              f"{time.time()-t0:.1f}s")
    return dict(out, params=params, opt=opt, cfg=cfg, tc=tc,
                step_fn=step_fn, mesh=mesh)


if __name__ == "__main__":
    main()
