"""The JAX side of the port's scale-out tests, run in a process of its
own with 4 host devices (``XLA_FLAGS=--xla_force_host_platform_device_
count=4``, which must be set before JAX starts):

    python jax_scaleout_ref.py CASE IN.npz OUT.npz

CASE ``moe_ep``: ``moe_ffn_ep`` on a (2, 2) (data, model) mesh for each
capacity factor and dispatch mode, y, aux, the gradients of
sum(y * r) + 0.37 * aux, and the assignments each source shard drops;
``pipeline``: ``pipeline_apply`` on a (2, 2) (pipe, dp) mesh and a
(4, 1) one, and its gradients; ``sharded_step``: the launcher's sharded
train step; ``serve_steps``: the dry-run's prefill and serve steps
jitted under ``serve_shardings`` on a (2, 2) or a (1, 4) mesh; ``many``:
several of those in one process (``many``'s docstring)."""
import sys

import jax
import jax.numpy as jnp
import numpy as np

AUX_W = 0.37


def moe_ep(z):
    from repro.models.moe import router_topk
    from repro.models.moe_ep import (_local_dispatch, ep_mesh_context,
                                     moe_ffn_ep)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    k = int(z["k"])
    x, r = jnp.asarray(z["x"]), jnp.asarray(z["r"])
    ws = tuple(jnp.asarray(z[n]) for n in ("wr", "wg", "wu", "wd"))
    E = ws[0].shape[1]
    out = {}
    for cf in z["cfs"]:
        cf = float(cf)
        for tp in (False, True):
            def loss(x, *w):
                with ep_mesh_context(mesh, tp_dispatch=tp):
                    o = moe_ffn_ep(x, *w, k=k, capacity_factor=cf)
                return jnp.sum(o.y * r) + AUX_W * o.aux_loss, (o.y,
                                                               o.aux_loss)
            with mesh:
                (_, (y, aux)), g = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(x, *ws)
            key = f"cf{cf}_tp{int(tp)}"
            out[key + "_y"], out[key + "_aux"] = np.asarray(y), np.asarray(aux)
            for n, gi in zip(("x", "wr", "wg", "wu", "wd"), g):
                out[f"{key}_g{n}"] = np.asarray(gi)
            # the drops of each source shard's dispatch (moe_ffn_ep's own
            # buffers; the function returns no count)
            shards = 4 if tp else 2
            rows = x.shape[0] // shards
            C = max(int(rows * k * cf / E), 1)
            C = -(-C // 8) * 8
            dropped = 0
            for s in range(shards):
                xs = x[s * rows:(s + 1) * rows]
                logits = jnp.einsum("nd,de->ne", xs, ws[0],
                                    preferred_element_type=jnp.float32)
                w, idx = router_topk(logits, k)
                keep = _local_dispatch(xs, w, idx, E, C)[-1]
                dropped += int(np.sum(~np.asarray(keep)))
            out[key + "_dropped"] = np.asarray(dropped)
    return out


def pipeline(z):
    from repro.launch.pipeline import pipeline_apply
    W, b, x, r = (jnp.asarray(z[n]) for n in ("W", "b", "x", "r"))

    def stage(p, a):
        w, bb = p
        return jnp.tanh(a @ w + bb)
    out = {}
    for shape in ((2, 2), (4, 1)):
        mesh = jax.make_mesh(shape, ("pipe", "dp"))
        S = shape[0]

        def loss(p, xx):
            y = pipeline_apply(stage, mesh, "pipe", p, xx)
            return jnp.sum(y * r), y
        with mesh:
            (_, y), ((gW, gb), gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))((W[:S], b[:S]), x)
        out[f"pipe{S}"] = np.asarray(y)
        out[f"pipe{S}_gW"], out[f"pipe{S}_gb"] = np.asarray(gW), np.asarray(gb)
        out[f"pipe{S}_gx"] = np.asarray(gx)
    return out


def sharded_step(z):
    """The JAX launcher's sharded step (``train_shardings`` on a (2, 2)
    mesh, or on ``z["mesh"]``, under ``ep_mesh_context`` where
    ``z["ep"]``, with
    ``z["microbatch"]``) from the port's checkpoint of step 0, on
    batches with the first 3 r + 1 tokens of row r masked where
    ``z["masked"]`` (``scaleout_ranks.masked``): the losses and the
    params after each step."""
    from contextlib import nullcontext
    from jax.sharding import PartitionSpec as P
    from repro.checkpoint.checkpoint import restore
    from repro.configs import TrainConfig, get_config
    from repro.configs.base import ShapeConfig
    from repro.data.pipeline import DataConfig, make_batch
    from repro.launch import sharding as shd
    from repro.models import model as jm
    from repro.models.moe_ep import ep_mesh_context
    from repro.train import optim
    from repro.train.step import build_train_step
    from repro.utils.tree import flatten_with_paths
    cfg = get_config(str(z["arch"]), smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    if "capacity_factor" in z:
        cfg = cfg.replace(capacity_factor=float(z["capacity_factor"]))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                     microbatch=int(z["microbatch"]))
    abst = jm.abstract(cfg)
    opt = optim.abstract_opt_state(abst, tc)
    tree, _ = restore(str(z["ckpt"]), {"params": abst, "m": opt.m,
                                       "v": opt.v, "count": opt.count})
    params = tree["params"]
    opt = optim.OptState(m=tree["m"], v=tree["v"], count=tree["count"])
    shape = ShapeConfig("t", "train", int(z["S"]), int(z["B"]))
    # GSPMD's propagation (Auto axes), as the launcher's jit relies on
    shape_ = tuple(int(x) for x in z["mesh"]) if "mesh" in z else (2, 2)
    mesh = jax.make_mesh(shape_, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def batch(i):
        b = make_batch(cfg, shape, DataConfig(), i)
        if bool(z["masked"]):
            b["loss_mask"] = b["loss_mask"].copy()
            for r in range(b["loss_mask"].shape[0]):
                b["loss_mask"][r, :3 * r + 1] = 0
        return {k: jnp.asarray(v) for k, v in b.items()}
    batches = [batch(i) for i in range(int(z["steps"]))]
    ps = shd.param_specs(cfg, abst, mesh, kind="train")
    zs = shd.zero1_opt_specs(ps, abst, mesh)
    bs = shd.batch_specs(batches[0], mesh)
    opt_spec = optim.OptState(m=zs, v=zs, count=P())
    out = {}
    ep = ep_mesh_context(mesh) if bool(z["ep"]) else nullcontext()
    with mesh, ep:
        fn = jax.jit(build_train_step(cfg, tc),
                     in_shardings=(shd.to_named(ps, mesh),
                                   shd.to_named(opt_spec, mesh),
                                   shd.to_named(bs, mesh)),
                     out_shardings=(shd.to_named(ps, mesh),
                                    shd.to_named(opt_spec, mesh), None))
        for i, b in enumerate(batches):
            params, opt, m = fn(params, opt, b)
            out[f"loss{i}"] = np.asarray(m["total_loss"])
            out[f"aux{i}"] = np.asarray(m["aux_loss"])
            out[f"gnorm{i}"] = np.asarray(m["grad_norm"])
            for path, leaf in flatten_with_paths(params):
                out[f"step{i}/{path}"] = np.asarray(leaf)
    return out


#: the config fields a serving run may override (``serve_steps``)
SERVE_OVERRIDES = {"capacity_factor": float, "num_heads": int,
                   "num_kv_heads": int}


def serve_steps(z):
    """For each run of ``z["archs"]`` (a run id: the arch ``z[id +
    "/arch"]``, the id itself where absent; its smoke config in f32, with
    the ``SERVE_OVERRIDES`` given as ``z[id + "/" + field]``), from the
    port's checkpoint ``z[id + "/ckpt"]``: the dry-run's
    ``build_prefill_step`` jitted with ``serve_shardings``' params,
    ``batch_specs`` and ``cache_specs`` on a mesh of ``z["mesh"]`` ((2, 2)
    where absent) on the batch ``z[id + "/" + key]`` into a cache of
    ``z[id + "/max_len"]`` (else ``z["max_len"]``) slots, then
    ``z["steps"]`` of its ``build_serve_step`` from the prefill's greedy
    token: each step's tokens and the last cache."""
    from repro.checkpoint.checkpoint import restore
    from repro.configs import get_config
    from repro.launch import sharding as shd
    from repro.models import model as jm
    from repro.train.step import build_prefill_step, build_serve_step
    shape = tuple(int(x) for x in z["mesh"]) if "mesh" in z else (2, 2)
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    steps = int(z["steps"])
    out = {}
    for rid in (str(a) for a in z["archs"]):
        arch = str(z[rid + "/arch"]) if rid + "/arch" in z else rid
        max_len = int(z[rid + "/max_len"] if rid + "/max_len" in z
                      else z["max_len"])
        over = {k: f(z[f"{rid}/{k}"]) for k, f in SERVE_OVERRIDES.items()
                if f"{rid}/{k}" in z}
        cfg = get_config(arch, smoke=True).replace(
            param_dtype="float32", compute_dtype="float32", **over)
        abst = jm.abstract(cfg)
        params = restore(str(z[rid + "/ckpt"]), abst)[0]
        batch = {k.split("/", 1)[1]: jnp.asarray(z[k]) for k in z
                 if k.startswith(rid + "/") and k.split("/", 1)[1] in
                 ("tokens", "patch_embeds", "enc_embeds")}
        B = batch["tokens"].shape[0]
        cross = batch["enc_embeds"].shape[1] if "enc_embeds" in batch \
            else 1500
        cache = jm.init_cache(cfg, B, max_len, abstract_only=True,
                              cross_len=cross)
        sh = shd.serve_shardings(cfg, mesh, abst, cache, B)
        bs = shd.to_named(shd.batch_specs(batch, mesh), mesh)
        with mesh:
            pre = jax.jit(build_prefill_step(cfg, max_len),
                          in_shardings=(sh["params"], bs),
                          out_shardings=(None, sh["cache"]))
            serve = jax.jit(build_serve_step(cfg),
                            in_shardings=(sh["params"], sh["token"],
                                          sh["cache"]),
                            out_shardings=(sh["token"], sh["cache"]))
            logits, cache = pre(params, batch)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            out[f"{rid}/logits"] = np.asarray(logits)
            out[f"{rid}/tok0"] = np.asarray(tok)
            for i in range(steps):
                tok, cache = serve(params, tok, cache)
                out[f"{rid}/tok{i + 1}"] = np.asarray(tok)
        for k, v in cache.items():
            out[f"{rid}/cache/{k}"] = np.asarray(v)
        # the cache's specs, as the steps laid it
        for k, s in sh["cache"].items():
            out[f"{rid}/spec/{k}"] = np.asarray(repr(s.spec))
    return out


def many(z):
    """Each run of ``z["runs"]``: the case ``z[run + ":case"]`` on the
    inputs ``z[run + ":" + key]``, its outputs returned under ``run +
    ":" + key``."""
    out = {}
    for run in (str(r) for r in z["runs"]):
        pre = run + ":"
        sub = {k[len(pre):]: v for k, v in z.items() if k.startswith(pre)}
        res = CASES[str(sub.pop("case"))](sub)
        out.update({pre + k: v for k, v in res.items()})
    return out


CASES = {"moe_ep": moe_ep, "pipeline": pipeline, "sharded_step": sharded_step,
         "serve_steps": serve_steps, "many": many}


if __name__ == "__main__":
    case, src, dst = sys.argv[1:4]
    assert jax.device_count() == 4, jax.devices()
    np.savez(dst, **CASES[case](dict(np.load(src))))
