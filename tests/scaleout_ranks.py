"""Multi-rank harness of the port's scale-out tests: ``spawn`` runs a
function of this module in ``world`` gloo ranks on the CPU (one process
each, over a ``FileStore``), and the rank functions below run the port's
side of each check and return what the test compares.  Imports no JAX:
the JAX side runs in its own process (``jax_scaleout_ref.py``)."""
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, store, name, args, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = globals()[name](rank, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(name: str, tmp_path, *args, world: int = 4) -> list:
    """``name(rank, *args)`` in ``world`` spawned gloo ranks; each rank's
    return value, in rank order.  A failing rank fails the call."""
    out_dir = os.path.join(str(tmp_path), f"ranks_{name}")
    os.makedirs(out_dir, exist_ok=True)
    mp.start_processes(_entry, args=(world, os.path.join(out_dir, "store"),
                                     name, args, out_dir),
                       nprocs=world, start_method="spawn", join=True)
    # written by the ranks above (placements and tuples: not weights only)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_process(case, inp, out):
    """Start ``jax_scaleout_ref.py CASE`` on 4 host devices."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "jax_scaleout_ref.py"),
         case, str(inp), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def jax_result(proc, out, timeout=300):
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(out))


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


#: moe_ffn_ep's loss for gradients: sum(y * r) + AUX_W * aux
AUX_W = 0.37


def moe_ep_rank(rank, inp_path, k, cases, aux_w=AUX_W):
    """On a (2, 2) (data, model) mesh: for each (capacity_factor,
    tp_dispatch) of ``cases``, moe_ffn_ep on this rank's shards of the
    inputs, and the gradients of sum(y * r) + aux_w * aux."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.moe_ep import ep_mesh_context, moe_ffn_ep
    mesh = make_debug_mesh((2, 2))
    di, mi = mesh.get_coordinate()
    z = np.load(inp_path)
    N, E, f = z["x"].shape[0], z["wg"].shape[0], z["wg"].shape[2]
    rows, ne, nf = N // 2, E // 2, f // 2
    out = {}
    for cf, tp in cases:
        x = _t(z["x"][di * rows:(di + 1) * rows], True)
        r = _t(z["r"][di * rows:(di + 1) * rows])
        wr = _t(z["wr"], True)
        e, c = slice(di * ne, (di + 1) * ne), slice(mi * nf, (mi + 1) * nf)
        wg, wu = _t(z["wg"][e, :, c], True), _t(z["wu"][e, :, c], True)
        wd = _t(z["wd"][e, c, :], True)
        with ep_mesh_context(mesh, tp_dispatch=tp):
            o = moe_ffn_ep(x, wr, wg, wu, wd, k=k, capacity_factor=cf,
                           with_aux=True)
        (torch.sum(o.y * r) + aux_w * o.aux_loss).backward()
        out[(cf, tp)] = {"y": o.y.detach(), "aux": o.aux_loss.detach(),
                         "dropped": o.fraction_dropped, "x": x.grad,
                         "wr": wr.grad, "wg": wg.grad, "wu": wu.grad,
                         "wd": wd.grad}
    return {"coord": (di, mi), "out": out}


def analyze_moe_ep_rank(rank, arch):
    """``step_analyzer.analyze`` of ``moe_ffn_ep``'s forward at the smoke
    config of ``arch`` on a (2, 2) (data, model) mesh, each rank's shards
    ``device="meta"`` (64 tokens a rank): the collectives it counted, and
    the bytes of the rank's ``[E, C, d]`` dispatch buffer."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.moe import capacity
    from repro_torch.models.moe_ep import ep_mesh_context, moe_ffn_ep
    from repro_torch.utils.step_analyzer import analyze
    cfg = get_config(arch, smoke=True)
    mesh = make_debug_mesh((2, 2))
    N, d, E, f = 64, cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    k, cf = cfg.experts_per_token, cfg.capacity_factor
    dt = torch.float32

    def meta(*shape):
        return torch.empty(shape, dtype=dt, device="meta")
    with ep_mesh_context(mesh):
        cost = analyze(lambda *a: moe_ffn_ep(*a, k=k, capacity_factor=cf).y,
                       meta(N, d), meta(d, E), meta(E // 2, d, f // 2),
                       meta(E // 2, d, f // 2), meta(E // 2, f // 2, d))
    return {"counts": cost.collective_counts,
            "bytes": cost.collective_bytes,
            "buffer": E * capacity(N, k, cf, E) * d * 4}


def pipeline_rank(rank, inp_path):
    """``pipeline_apply`` of a tanh-affine stage on a (2, 2) (pipe, dp)
    mesh and a (4, 1) one, the stage parameters as this rank's plain
    slice and as DTensors sharded over 'pipe': the output, and the
    gradients of sum(y * r) for this rank's stage (W, b) and for x."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.pipeline import pipeline_apply
    from repro_torch.launch.sharding import NamedSharding, P
    from repro_torch.train.sharded import distribute
    z = np.load(inp_path)
    W, b, x, r = (_t(z[n]) for n in ("W", "b", "x", "r"))

    def stage(p, a):
        w, bb = p
        return torch.tanh(a @ w + bb)
    out = {}
    for shape in ((2, 2), (4, 1)):
        mesh = make_debug_mesh(shape, ("pipe", "dp"))
        S, s = shape[0], mesh.get_coordinate()[0]
        sh = NamedSharding(mesh, P("pipe"))
        out[f"stage{S}"] = s
        for held, ps in (("", (W[s:s + 1].clone(), b[s:s + 1].clone())),
                         ("_dtensor", (distribute(W[:S].contiguous(), sh),
                                       distribute(b[:S].contiguous(),
                                                  sh)))):
            ps = tuple(p.requires_grad_(True) for p in ps)
            xx = x.clone().requires_grad_(True)
            y = pipeline_apply(stage, mesh, "pipe", ps, xx)
            torch.sum(y * r).backward()
            key = f"pipe{S}{held}"
            out[key] = y.detach()
            out[key + "_gx"] = xx.grad
            for n, p in zip(("W", "b"), ps):
                g = p.grad.to_local() if hasattr(p.grad, "to_local") \
                    else p.grad
                out[f"{key}_g{n}"] = g[0]
    return out


def restore_rank(rank, ckpt_dir):
    """``restore`` of a checkpoint saved without a mesh onto a (2, 2)
    mesh, with a tree of shardings and with one for every leaf: each
    leaf's local shard, placements and whole value."""
    from repro_torch.checkpoint.checkpoint import restore
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import NamedSharding, P
    mesh = make_debug_mesh((2, 2))
    tmpl = {"w": torch.empty(8, 8), "b": torch.empty(8),
            "h": torch.empty(4, 6, dtype=torch.bfloat16)}
    tree = {"w": NamedSharding(mesh, P(None, "model")),
            "b": NamedSharding(mesh, P()),
            "h": NamedSharding(mesh, P("data", "model"))}
    out = {"coord": mesh.get_coordinate()}
    for name, sh in (("tree", tree), ("one", NamedSharding(mesh, P("data")))):
        got, step = restore(ckpt_dir, tmpl, shardings=sh)
        out[name] = {key: (v.to_local().clone(), tuple(v.placements),
                           v.full_tensor()) for key, v in got.items()}
        out["step"] = step
    return out


def masked(batch: dict) -> dict:
    """``batch`` with the first 3 r + 1 tokens of row r out of the loss
    (``jax_scaleout_ref.py`` masks the same): the rows count different
    tokens, so the microbatches of a global batch do too."""
    mask = batch["loss_mask"].copy()
    for r in range(mask.shape[0]):
        mask[r, :3 * r + 1] = 0
    return dict(batch, loss_mask=mask)


def _step_inputs(arch, over, opts, B, S):
    """The smoke config in f32 with ``over``, the TrainConfig with
    ``opts``' microbatch, the seed-0 params and AdamW state, and the
    batch of each step (``masked`` where ``opts`` asks)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as tm
    from repro_torch.train import optim
    cfg = get_config(arch, smoke=True).replace(**F32, **over)
    tc = TrainConfig(**STEP_TC, microbatch=opts.get("microbatch", 0))
    params = tm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = optim.init_opt_state(params, tc)
    shape = ShapeConfig("t", "train", S, B)

    def batch(i):
        b = make_batch(cfg, shape, DataConfig(), i)
        b = masked(b) if opts.get("masked") else b
        return {n: torch.from_numpy(v) for n, v in b.items()}
    return cfg, tc, params, opt, batch


def sharded_steps_rank(rank, runs, B, S, steps):
    """For each (arch, ep, config overrides[, options]) of ``runs``:
    ``steps`` sharded train steps of the arch's smoke config in f32 on a
    (2, 2) mesh from the seed-0 params, batches of B x S (options:
    ``microbatch``, and ``masked`` batches): the metrics of each step,
    the stored placements of the first layer's leaves and moments and,
    on rank 0, the final params gathered whole."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import train_shardings
    from repro_torch.train.sharded import (build_sharded_train_step,
                                           gather_state, shard_state)
    from repro_torch.utils.tree import flatten_with_paths
    mesh = make_debug_mesh((2, 2))
    outs = []
    for arch, ep, over, *opts in runs:
        cfg, tc, params, opt, batch = _step_inputs(arch, over,
                                                   dict(*opts), B, S)
        sh = train_shardings(cfg, mesh, params, opt, batch(0), tc)
        params, opt = shard_state(params, opt, sh)
        step = build_sharded_train_step(cfg, tc, sh, ep=ep)
        out = {"metrics": []}
        for i in range(steps):
            params, opt, m = step(params, opt, batch(i))
            out["metrics"].append({n: float(v) for n, v in m.items()})
        out["placements"] = {
            p: (tuple(a.placements), tuple(b.placements)) for (p, a), (_, b)
            in zip(flatten_with_paths(params), flatten_with_paths(opt.m))}
        full = gather_state(params)
        if rank == 0:
            out["params"] = full
        outs.append(out)
    return outs


def uneven_microbatch_rank(rank, arch, B, S, mb):
    """The sharded step with a microbatch that does not split over the
    (2, 2) mesh's 2 data ranks: the ``ValueError``'s message."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import train_shardings
    from repro_torch.train.sharded import (build_sharded_train_step,
                                           shard_state)
    mesh = make_debug_mesh((2, 2))
    cfg, tc, params, opt, batch = _step_inputs(arch, {}, {"microbatch": mb},
                                               B, S)
    sh = train_shardings(cfg, mesh, params, opt, batch(0), tc)
    params, opt = shard_state(params, opt, sh)
    step = build_sharded_train_step(cfg, tc, sh)
    try:
        step(params, opt, batch(0))
    except ValueError as e:
        return str(e)
    return None


def sharded_checks_rank(rank, runs, B, S, steps, uneven_mb):
    """``sharded_steps_rank`` of ``runs`` and ``uneven_microbatch_rank``
    of the dense smoke, in one spawn."""
    return {"steps": sharded_steps_rank(rank, runs, B, S, steps),
            "uneven": uneven_microbatch_rank(rank, "qwen3-0.6b", B, S,
                                             uneven_mb)}


#: the sharded-step tests' optimizer and dtypes
STEP_TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def one_rank_steps(arch, over, B, S, steps, opts=None, grads=False):
    """The port's one-rank steps of ``sharded_steps_rank``'s runs, from
    the same params and batches: the metrics of each step and the final
    params (and, with ``grads``, each step's gradients)."""
    from repro_torch.train.step import (build_loss_fn, build_train_step,
                                        value_and_grad)
    cfg, tc, p, o, batch = _step_inputs(arch, over, opts or {}, B, S)
    step = build_train_step(cfg, tc)
    ms, gs = [], []
    for i in range(steps):
        if grads:
            gs.append(value_and_grad(build_loss_fn(cfg), p, batch(i))[1])
        p, o, m = step(p, o, batch(i))
        ms.append({n: float(v) for n, v in m.items()})
    return (ms, p, gs) if grads else (ms, p)


def tp_train_rank(rank, shapes, runs, B, S, steps):
    """For each mesh shape of ``shapes`` (axes data, model) and each
    (arch, ep, config overrides) of ``runs``: ``steps`` sharded train
    steps of the arch's smoke config in f32 from the seed-0 params,
    batches of B x S: the metrics of each step, the step's
    ``tp_leaves``, the shapes of this rank's compute tensors and the
    leaves whose compute tensor took an all-gather, and on rank 0 the
    final params gathered whole."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import train_shardings
    from repro_torch.train.sharded import (build_sharded_train_step,
                                           gather_state, shard_state)
    from repro_torch.utils.step_analyzer import CollectiveCounter
    from repro_torch.utils.tree import flatten_with_paths
    outs = {}
    for shape in shapes:
        mesh = make_debug_mesh(shape)
        for arch, ep, over in runs:
            cfg, tc, params, opt, batch = _step_inputs(arch, over, {}, B, S)
            sh = train_shardings(cfg, mesh, params, opt, batch(0), tc)
            params, opt = shard_state(params, opt, sh)
            step = build_sharded_train_step(cfg, tc, sh, ep=ep)
            out = {"tp": step.tp_leaves, "compute": {}, "gathered": set(),
                   "metrics": []}
            for path, leaf in flatten_with_paths(params):
                with CollectiveCounter() as c:
                    t, = step.compute_leaves(_nest(path, leaf))
                out["compute"][path] = tuple(t.shape)
                if c.counts.get("all-gather"):
                    out["gathered"].add(path)
            for i in range(steps):
                params, opt, m = step(params, opt, batch(i))
                out["metrics"].append({n: float(v) for n, v in m.items()})
            full = gather_state(params)
            if rank == 0:
                out["params"] = full
            outs[(shape, arch, ep)] = out
    return outs


def _nest(path: str, leaf):
    """A tree of one leaf at ``path``."""
    for key in reversed(path.split("/")):
        leaf = {key: leaf}
    return leaf


def tp_locality_rank(rank, arch, B, S):
    """``step_analyzer.analyze`` on a (2, 2) mesh of the loss forward and
    of the loss and gradients of the tensor-parallel train step (its
    compute tensors, under its context) and of the gathered compute (the
    whole params, no context), on this rank's block of the batch: each
    one's collectives, argument bytes and peak temporary bytes."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import train_shardings
    from repro_torch.train.sharded import (build_sharded_train_step,
                                           local_block, shard_state)
    from repro_torch.train.step import build_loss_fn, value_and_grad
    from repro_torch.utils.step_analyzer import analyze
    from repro_torch.utils.tree import flatten_with_paths, tree_unflatten
    mesh = make_debug_mesh((2, 2))
    cfg, tc, whole, opt, batch = _step_inputs(arch, {}, {}, B, S)
    sh = train_shardings(cfg, mesh, whole, opt, batch(0), tc)
    params, _ = shard_state(whole, opt, sh)
    step = build_sharded_train_step(cfg, tc, sh)
    lb = {k: local_block(v, sh["batch"][k]) for k, v in batch(0).items()}
    loss_fn = build_loss_fn(cfg)

    def fwd(c, b):
        return loss_fn(tree_unflatten(params, c), b)[0]

    def fwd_bwd(c, b):
        return value_and_grad(loss_fn, tree_unflatten(params, c), b)
    out = {"layers": cfg.num_layers, "remat": cfg.remat}
    runs = {"tp": step.compute_leaves(params),
            "gathered": [t for _, t in flatten_with_paths(whole)]}
    for name, compute in runs.items():
        for kind, fn in (("forward", fwd), ("step", fwd_bwd)):
            if name == "tp":
                with step.context():
                    c = analyze(fn, compute, lb)
            else:
                c = analyze(fn, compute, lb)
            out[name, kind] = {"counts": c.collective_counts,
                               "arguments": c.argument_bytes,
                               "temporaries": c.peak_temp_bytes,
                               "flops": c.flops}
    return out


def tp_train_checks_rank(rank, shapes, runs, B, S, steps, arch):
    """``tp_train_rank`` and ``tp_locality_rank`` in one spawn."""
    return {"train": tp_train_rank(rank, shapes, runs, B, S, steps),
            "locality": tp_locality_rank(rank, arch, B, S)}


def serve_inputs(arch, over, B, S):
    """The smoke config of ``arch`` in f32 with ``over``, the seed-0
    params and the prefill batch of B rows x S tokens that
    ``concrete_inputs`` draws from seed 1."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import concrete_inputs
    from repro_torch.models import model as tm
    cfg = get_config(arch, smoke=True).replace(**F32, **over)
    params = tm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = concrete_inputs(cfg, ShapeConfig("p", "prefill", S, B), rng=1)
    return cfg, params, batch


def tp_serve_rank(rank, shape, runs, B, S, max_len, steps):
    """For each (arch, config overrides[, max_len, ep]) of ``runs`` on a
    mesh of ``shape``: the sharded prefill of ``serve_inputs``' batch into
    a cache of ``max_len`` slots (the run's own where given; with ``ep``
    the MoE layers expert-parallel) and ``steps``
    sharded serve steps from its greedy token: each step's tokens, the
    prefill's logits and the last cache gathered whole, the shapes of this
    rank's cache blocks and the collectives of the last serve step by
    kind."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import serve_shardings
    from repro_torch.models import model as tm
    from repro_torch.train.sharded import distribute
    from repro_torch.train.sharded_serve import (build_sharded_prefill_step,
                                                 build_sharded_serve_step,
                                                 greedy)
    from repro_torch.utils.step_analyzer import CollectiveCounter
    from repro_torch.utils.tree import tree_map
    mesh = make_debug_mesh(shape)
    outs = []
    for arch, over, *own in runs:
        ml = own[0] if own else max_len
        ep = own[1] if own[1:] else False
        cfg, params, batch = serve_inputs(arch, over, B, S)
        cross = batch["enc_embeds"].shape[1] if "enc_embeds" in batch \
            else 1500
        cache = tm.init_cache(cfg, B, ml, abstract_only=True,
                              cross_len=cross)
        sh = serve_shardings(cfg, mesh, params, cache, B)
        prefill = build_sharded_prefill_step(cfg, ml, sh, ep=ep)
        serve = build_sharded_serve_step(cfg, sh, ep=ep)
        p = tree_map(distribute, params, sh["params"])
        logits, c = prefill(p, batch)
        tok = greedy(logits, cfg)
        toks = [tok.full_tensor()]
        for i in range(steps):
            with CollectiveCounter() as counted:
                tok, c = serve(p, tok, c)
            toks.append(tok.full_tensor())
        outs.append({"tokens": toks, "logits": logits.full_tensor(),
                     "cache": {k: v.full_tensor() for k, v in c.items()},
                     "local": {k: tuple(v.to_local().shape)
                               for k, v in c.items()},
                     "collectives": dict(counted.counts)})
    return outs


def tp_helpers_rank(rank, inp_path):
    """``models/tp.py``'s helpers on a (2, 2) mesh, each rank given its
    model-axis block of the whole inputs: the vocab-parallel embedding,
    log-sum-exp and gold logit (values, and the gradients of
    sum(lse * a) - sum(gold * b) by their logits), the greedy index
    (rows whose max ties across the ranks' columns), and ``gather_last``
    (its output and the gradient of sum(out * r))."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import tp
    mesh = make_debug_mesh((2, 2))
    _, mi = mesh.get_coordinate()
    z = np.load(inp_path)
    V = z["table"].shape[0]
    cols = slice(mi * V // 2, (mi + 1) * V // 2)
    with tp.tp_mesh_context(mesh):
        emb = tp.vocab_embed(_t(z["table"][cols]), _t(z["tokens"]), V)
        logits = _t(z["logits"][..., cols], True)
        lse, gold = tp.vocab_lse_gold(logits, _t(z["labels"]), V)
        (torch.sum(lse * _t(z["a"])) - torch.sum(gold * _t(z["b"]))
         ).backward()
        top = tp.vocab_argmax(_t(z["ties"][..., cols]), V)
        x = _t(z["x"][..., mi * 4:(mi + 1) * 4], True)
        g = tp.gather_last(x)
        torch.sum(g * _t(z["r"])).backward()
    return {"model": mi, "embed": emb, "lse": lse.detach(),
            "gold": gold.detach(), "dlogits": logits.grad, "argmax": top,
            "gathered": g.detach(), "dx": x.grad}


def tp_serve_checks_rank(rank, runs, B, S, max_len, steps, helpers):
    """``tp_serve_rank`` of ``runs`` on (2, 2) and ``tp_helpers_rank`` of
    ``helpers``, in one spawn."""
    return {"served": tp_serve_rank(rank, (2, 2), runs, B, S, max_len,
                                    steps),
            "helpers": tp_helpers_rank(rank, helpers)}


def cli_rank(rank, argvs):
    """``repro_torch.launch.train.main(argv)`` for each of ``argvs`` on
    the ranks' process group: each run's losses and the calls of
    ``moe_ffn_ep`` it made."""
    from repro_torch.launch import train
    from repro_torch.models.moe_ep import moe_ffn_ep
    out = []
    for argv in argvs:
        before = moe_ffn_ep.calls
        res = train.main(argv)
        out.append({"losses": res["losses"], "start": res["start"],
                    "ep_calls": moe_ffn_ep.calls - before,
                    "layers": res["cfg"].num_layers})
    return out


def smoke_rank(rank, moe_inp, k, pipe_inp, ckpt_dir, runs, B, S, steps):
    """The checks of ``chip_smoke.py``'s phase 26 in one spawn: the
    expert-parallel MoE at factor 32 without the aux term, the pipeline,
    the sharded steps of ``runs`` and the elastic restore."""
    return {"moe_ep": moe_ep_rank(rank, moe_inp, k,
                                  [(32.0, False), (32.0, True)], 0.0),
            "pipeline": pipeline_rank(rank, pipe_inp),
            "steps": sharded_steps_rank(rank, runs, B, S, steps),
            "restore": restore_rank(rank, ckpt_dir)}


def mamba_holdings_rank(rank, shape, runs, B, S, max_len):
    """For each (arch, config overrides) of ``runs`` on a mesh of
    ``shape``: what the sharded serving steps compute with, taken leaf by
    leaf under a collective counter: each parameter's compute tensor's
    shape and whether taking it all-gathered, and each cache leaf's
    (after a prefill of ``serve_inputs``' batch) likewise, through the
    decode step's ``cache_in``."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import serve_shardings
    from repro_torch.models import model as tm
    from repro_torch.train.sharded import distribute
    from repro_torch.train.sharded_serve import (build_sharded_decode_step,
                                                 build_sharded_prefill_step)
    from repro_torch.utils.step_analyzer import CollectiveCounter
    from repro_torch.utils.tree import flatten_with_paths, tree_map
    mesh = make_debug_mesh(shape)
    out = {}
    for arch, over in runs:
        cfg, params, batch = serve_inputs(arch, over, B, S)
        cache = tm.init_cache(cfg, B, max_len, abstract_only=True)
        sh = serve_shardings(cfg, mesh, params, cache, B)
        p = tree_map(distribute, params, sh["params"])
        _, c = build_sharded_prefill_step(cfg, max_len, sh)(p, batch)
        plan = build_sharded_decode_step(cfg, sh).plan
        got = {"params": {}, "cache": {}}
        for path, leaf in flatten_with_paths(p):
            with CollectiveCounter() as n:
                t = plan.params(_nest(path, leaf))
            got["params"][path] = (tuple(flatten_with_paths(t)[0][1].shape),
                                   n.counts.get("all-gather", 0))
        for name, leaf in c.items():
            with CollectiveCounter() as n:
                t = plan.cache_in({name: leaf})[name]
            got["cache"][name] = (tuple(t.shape),
                                  n.counts.get("all-gather", 0))
        out[arch] = got
    return out


def gated_norm_split_rank(rank, inp_path):
    """``layers.gated_rms_norm_split`` on a (1, 4) mesh, each model rank
    given its quarter of the columns of y, z and w (the plain route on
    the CPU): the output, and the gradients of sum(out * r) for y, z and
    w, of its columns; and ``tp.model_summer()``'s function, taken under
    the context, called on another thread (as autograd calls a CUDA
    backward): that thread's context, and the sum of the rank's row sums
    of y it gives."""
    import threading
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import tp
    from repro_torch.models.layers import gated_rms_norm_split
    mesh = make_debug_mesh((1, 4))
    mi = mesh.get_coordinate()[1]
    z = np.load(inp_path)
    d = z["y"].shape[-1]
    cols = slice(mi * d // 4, (mi + 1) * d // 4)
    y, zz, w = (_t(z[k][..., cols], True) for k in ("y", "z", "w"))
    with tp.tp_mesh_context(mesh):
        out = gated_rms_norm_split(y, zz, w, d, 1e-6)
        torch.sum(out * _t(z["r"][..., cols])).backward()
        summer = tp.model_summer()
    seen = {}

    def elsewhere():
        seen["context"] = tp.current_tp()
        seen["sum"] = summer(y.detach().sum(-1))
    t = threading.Thread(target=elsewhere)
    t.start()
    t.join()
    return {"model": mi, "out": out.detach(), "dy": y.grad, "dz": zz.grad,
            "dw": w.grad, **{f"thread_{k}": v for k, v in seen.items()}}


def mamba_tp_checks_rank(rank, shapes, train_runs, B, S, steps, whole_run,
                         serve_runs, sB, sS, max_len, serve_steps,
                         norm_inp):
    """The Mamba2 tensor-parallel checks in one spawn: the train steps of
    ``train_runs`` on each mesh of ``shapes`` (``tp_train_rank``), one
    step of ``whole_run`` (a config whose heads M does not divide) on
    (1, 4), the sharded serving of ``serve_runs`` on each mesh
    (``tp_serve_rank``) and what it computes with
    (``mamba_holdings_rank``), ``tp_locality_rank`` of each train run's
    arch on (2, 2), and the split gated norm (``gated_norm_split_rank``)."""
    return {
        "train": tp_train_rank(rank, shapes, train_runs, B, S, steps),
        "whole": tp_train_rank(rank, [(1, 4)], [whole_run], B, S, 1),
        "served": {shape: tp_serve_rank(rank, shape, serve_runs, sB, sS,
                                        max_len, serve_steps)
                   for shape in shapes},
        "holdings": {shape: mamba_holdings_rank(rank, shape, serve_runs, sB,
                                                sS, max_len)
                     for shape in shapes},
        "locality": {arch: tp_locality_rank(rank, arch, B, S)
                     for arch, _, _ in train_runs},
        "norm": gated_norm_split_rank(rank, norm_inp)}
