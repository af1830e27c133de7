"""Tensor-parallel Mamba2 layers: each rank computes its H/M heads of
every Mamba2 layer (``models/ssm.py::mamba2_block`` under ``models/
tp.py``), over 4 gloo ranks on a (2, 2) and a (1, 4) (data, model)
mesh, for the smoke configs of mamba2-780m and zamba2-2.7b in f32
(8 SSM heads, G = 1: 4 and 2 heads a rank; zamba2's shared attention
splits its heads too):

* two TP train steps (``train/sharded.py``) against the port's one-rank
  step and the JAX launcher's sharded step under ``train_shardings`` on 4
  host devices (loss and every parameter within 1e-4, as
  ``test_torch_tp_train.py`` bounds them);
* the sharded prefill and 4 serve steps (``train/sharded_serve.py``)
  against the one-rank steps and JAX's ``serve_shardings`` steps: tokens
  equal, the prefill's logits and every cache leaf (gathered) within
  1e-5;
* the compute tensors each rank holds: H/M heads of ``out_proj``,
  ``norm_w``, ``dt_bias``, ``A_log``, ``D`` and of the SSM state, none
  of them all-gathered, and the conv state's channels ``[x_r | B | C]``;
* ``analyze``'s collectives per Mamba2 layer forward: one all-reduce for
  the gated norm's sum of squares and one for ``out_proj``;
* the split gated norm's plain version against the whole row's, with
  its gradient against autograd of the whole row, in one process and on
  the ranks;
* a config whose heads M does not divide, computed whole.

One spawn of the ranks and one JAX process per mesh serve the whole
file."""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import save
from repro_torch.configs import TrainConfig, get_config
from repro_torch.kernels.rmsnorm.ref import (gated_rmsnorm_dot_ref,
                                             gated_rmsnorm_ref,
                                             gated_rmsnorm_scale_bwd_ref,
                                             gated_rmsnorm_scale_ref,
                                             gated_rmsnorm_split_ref,
                                             gated_rmsnorm_sumsq_ref)
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.sharding import (MAMBA_COLUMNS, MAMBA_LOCAL,
                                         param_specs, tp_leaves)
from repro_torch.models import model as tm
from repro_torch.models import tp
from repro_torch.models.ssm import mamba2_dims
from repro_torch.train import optim
from repro_torch.train.step import build_prefill_step, build_serve_step
from repro_torch.utils.tree import flatten_with_paths

sys.path.insert(0, os.path.dirname(__file__))
import scaleout_ranks  # noqa: E402
from norm_grad_checks import close, dw_terms  # noqa: E402

torch.set_num_threads(1)
#: the train steps' batch: 2 rows (at 4 rows of seed-0 weights the JAX
#: package's zamba2 gradient is NaN: its plain scan's where(tri,
#: exp(seg), 0) overflows above the diagonal, the hazard
#: ``test_torch_ssd_grad.py`` pins; the port's is finite there)
B, S, STEPS = 2, 16, 2
SB, SS, MAX_LEN, SERVE_STEPS = 4, 8, 16, 4
SHAPES = [(2, 2), (1, 4)]
ARCHS = ["mamba2-780m", "zamba2-2.7b"]
TRAIN_RUNS = [(a, False, {}) for a in ARCHS]
SERVE_RUNS = [(a, {}) for a in ARCHS]
#: 2 SSM heads (head dim 64): on (1, 4) M does not divide them
WHOLE = ("mamba2-780m", False, {"ssm_head_dim": 64})
TOL, CLEAR, SERVE_TOL = 1e-4, 1e-6, 1e-5
LR = scaleout_ranks.STEP_TC["learning_rate"]
CASES = [(shape, arch) for shape in SHAPES for arch in ARCHS]


def _ids(x):
    return f"{x[0]}x{x[1]}" if isinstance(x, tuple) else str(x)


def _name(shape):
    return f"{shape[0]}x{shape[1]}"


def _cfg(arch, over=None):
    return get_config(arch, smoke=True).replace(**scaleout_ranks.F32,
                                                **(over or {}))


def _norm_inputs(tmp):
    r = np.random.default_rng(5)
    z = {"y": r.normal(0, 1, (3, 5, 32)), "z": r.normal(0, 2, (3, 5, 32)),
         "w": r.normal(1, 0.1, (32,)), "r": r.normal(0, 1, (3, 5, 32))}
    z = {k: v.astype(np.float32) for k, v in z.items()}
    np.savez(tmp / "norm.npz", **z)
    return z


def _jax_inputs(tmp):
    """The inputs of one ``many`` run of ``jax_scaleout_ref.py`` per mesh
    (``in_jax_DxM.npz``): the sharded train step of each arch, and the
    serving steps."""
    inp, runs = {}, []
    tc = TrainConfig(**scaleout_ranks.STEP_TC)
    for arch in ARCHS:
        p = tm.init(_cfg(arch), torch.Generator().manual_seed(0), "cpu")
        o = optim.init_opt_state(p, tc)
        ck = tmp / f"train_{arch}"
        save(str(ck), 0, {"params": p, "m": o.m, "v": o.v,
                          "count": o.count})
        _, params, batch = scaleout_ranks.serve_inputs(arch, {}, SB, SS)
        save(str(tmp / f"serve_{arch}"), 0, params)
        for shape in SHAPES:
            run = f"train_{arch}_{_name(shape)}"
            runs.append(run)
            inp.update({f"{run}:{k}": v for k, v in dict(
                case="sharded_step", arch=arch, ckpt=str(ck), B=B, S=S,
                steps=STEPS, ep=False, microbatch=0, masked=False,
                mesh=np.array(shape)).items()})
        for shape in SHAPES:
            run = f"serve_{_name(shape)}"
            inp[f"{run}:{arch}/ckpt"] = str(tmp / f"serve_{arch}")
            inp.update({f"{run}:{arch}/{k}": v.numpy()
                        for k, v in batch.items()})
    for shape in SHAPES:
        run = f"serve_{_name(shape)}"
        runs.append(run)
        inp.update({f"{run}:case": "serve_steps",
                    f"{run}:archs": np.array(ARCHS),
                    f"{run}:max_len": MAX_LEN, f"{run}:steps": SERVE_STEPS,
                    f"{run}:mesh": np.array(shape)})
    for shape in SHAPES:
        mine = [r for r in runs if r.endswith(_name(shape))]
        np.savez(tmp / f"in_jax_{_name(shape)}.npz", runs=np.array(mine),
                 **{k: v for k, v in inp.items()
                    if k.split(":")[0] in mine})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mamba_tp")
    _jax_inputs(tmp)
    procs = {_name(s): scaleout_ranks.jax_process(
        "many", tmp / f"in_jax_{_name(s)}.npz", tmp / f"jax_{_name(s)}.npz")
        for s in SHAPES}
    norm = _norm_inputs(tmp)
    try:
        ranks = scaleout_ranks.spawn(
            "mamba_tp_checks_rank", tmp, SHAPES, TRAIN_RUNS, B, S, STEPS,
            WHOLE, SERVE_RUNS, SB, SS, MAX_LEN, SERVE_STEPS,
            str(tmp / "norm.npz"))
    finally:
        ref = {}
        for name, proc in procs.items():
            ref.update(scaleout_ranks.jax_result(proc,
                                                 tmp / f"jax_{name}.npz"))
    return ranks, ref, norm


_ONE_RANK = {}


def one_rank_train(arch, over=None, steps=STEPS):
    key = (arch, tuple(sorted((over or {}).items())), steps)
    if key not in _ONE_RANK:
        _ONE_RANK[key] = scaleout_ranks.one_rank_steps(
            arch, over or {}, B, S, steps, grads=True)
    return _ONE_RANK[key]


def _train(ranks, shape, arch):
    outs = [r["train"][shape, arch, False] for r in ranks]
    for o in outs[1:]:
        assert o["metrics"] == outs[0]["metrics"]
    return outs[0]


def _assert_params_close(got, want, grads):
    """Every leaf within TOL where each step's one-rank gradient is clear
    of AdamW's epsilon, within 2 lr per step elsewhere
    (``test_torch_tp_train.py``'s bound)."""
    for (path, a), (_, b) in zip(flatten_with_paths(got),
                                 flatten_with_paths(want), strict=True):
        b = torch.as_tensor(b)
        assert a.shape == b.shape, path
        clear = torch.ones(a.shape, dtype=torch.bool)
        for g in grads:
            clear &= dict(flatten_with_paths(g))[path].abs() >= CLEAR
        d = (a - b).abs()
        strict = float(d[clear].max()) if clear.any() else 0.0
        assert strict <= TOL, (path, strict)
        assert float(d.max()) <= 2 * LR * len(grads), (path, float(d.max()))


@pytest.mark.parametrize("shape,arch", CASES, ids=_ids)
def test_tp_train_step_equals_the_one_rank_step(runs, shape, arch):
    ranks, _, _ = runs
    got = _train(ranks, shape, arch)
    ms, params, grads = one_rank_train(arch)
    for m, r in zip(got["metrics"], ms, strict=True):
        assert abs(m["total_loss"] - r["total_loss"]) <= TOL, (m, r)
        assert abs(m["grad_norm"] - r["grad_norm"]) <= TOL * r["grad_norm"]
    _assert_params_close(got["params"], params, grads)


@pytest.mark.parametrize("shape,arch", CASES, ids=_ids)
def test_tp_train_step_equals_jax_sharded_step(runs, shape, arch):
    """Loss and grad norm of each step within 1e-4 of JAX's sharded step
    (GSPMD's partition of the same rule table), every parameter after the
    last by the bound above."""
    ranks, ref, _ = runs
    pre = f"train_{arch}_{_name(shape)}:"
    got = _train(ranks, shape, arch)
    for i, m in enumerate(got["metrics"]):
        assert abs(m["total_loss"] - float(ref[f"{pre}loss{i}"])) <= TOL
        gn = float(ref[f"{pre}gnorm{i}"])
        assert abs(m["grad_norm"] - gn) <= TOL * gn
    want = {p: ref[f"{pre}step{STEPS - 1}/{p}"]
            for p, _ in flatten_with_paths(got["params"])}
    _assert_params_close(got["params"], want, one_rank_train(arch)[2])


def _split_shape(path, full, M):
    """The shape of the rank's shard of a split leaf: d_inner or the
    heads over M (``out_proj``'s rows, the others' last dim)."""
    want = list(full)
    want[-2 if path.endswith("out_proj") else -1] //= M
    return tuple(want)


@pytest.mark.parametrize("shape,arch", CASES, ids=_ids)
def test_each_rank_trains_its_heads_and_gathers_only_the_packed_leaves(
        runs, shape, arch):
    """The Mamba2 leaves ``tp_leaves`` names local are 1/M of the whole
    along the head dims, and taking them gathers nothing; ``in_proj``,
    ``conv_w`` and ``conv_b`` are gathered and summed."""
    ranks, _, _ = runs
    M = shape[1]
    whole = dict(flatten_with_paths(tm.abstract(_cfg(arch))))
    for r in ranks:
        out = r["train"][shape, arch, False]
        local, summed = out["tp"]
        mamba = {f"blocks/mamba/{n}" for n in MAMBA_LOCAL}
        assert mamba <= local
        assert {f"blocks/mamba/{n}" for n in MAMBA_COLUMNS} <= summed
        for p in mamba:
            assert out["compute"][p] == _split_shape(
                p, tuple(whole[p].shape), M), p
        assert not mamba & out["gathered"]
        assert {p for p in out["gathered"] if "mamba" in p} == {
            f"blocks/mamba/{n}" for n in MAMBA_COLUMNS}


def _served(ranks, shape, i):
    got = [r["served"][shape][i] for r in ranks]
    for g in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(g["tokens"],
                                                     got[0]["tokens"]))
    return got[0]


def one_rank_serve(arch):
    cfg, params, batch = scaleout_ranks.serve_inputs(arch, {}, SB, SS)
    logits, cache = build_prefill_step(cfg, MAX_LEN)(params, batch)
    tok = torch.argmax(logits, -1).to(torch.int32)
    toks, serve = [tok], build_serve_step(cfg)
    for _ in range(SERVE_STEPS):
        tok, cache = serve(params, tok, cache)
        toks.append(tok)
    return toks, logits, cache


@pytest.mark.parametrize("shape,arch", CASES, ids=_ids)
def test_sharded_serving_equals_one_rank(runs, shape, arch):
    ranks, _, _ = runs
    got = _served(ranks, shape, ARCHS.index(arch))
    toks, logits, cache = one_rank_serve(arch)
    for a, b in zip(got["tokens"], toks, strict=True):
        assert torch.equal(a, b), (arch, a, b)
    assert float((got["logits"] - logits).abs().max()) <= SERVE_TOL
    assert set(got["cache"]) == set(cache)
    for k, v in cache.items():
        d = float((got["cache"][k].float() - v.float()).abs().max())
        assert d <= SERVE_TOL, (arch, k, d)


@pytest.mark.parametrize("shape,arch", CASES, ids=_ids)
def test_sharded_serving_equals_jax_serve_shardings(runs, shape, arch):
    ranks, ref, _ = runs
    pre = f"serve_{_name(shape)}:{arch}/"
    got = _served(ranks, shape, ARCHS.index(arch))
    for i, a in enumerate(got["tokens"]):
        assert np.array_equal(a.numpy(), ref[f"{pre}tok{i}"]), (arch, i)
    assert np.abs(got["logits"].numpy() - ref[f"{pre}logits"]).max() \
        <= SERVE_TOL
    for k, v in got["cache"].items():
        want = ref[f"{pre}cache/{k}"]
        assert v.shape == want.shape, (arch, k)
        d = np.abs(v.float().numpy() - want.astype(np.float32)).max()
        assert d <= SERVE_TOL, (arch, k, d)


@pytest.mark.parametrize("shape,arch", CASES, ids=_ids)
def test_serving_holds_the_heads_and_gathers_no_head_leaf(runs, shape,
                                                          arch):
    """The serving steps compute with this rank's shards of ``out_proj``,
    ``norm_w``, ``dt_bias``, ``A_log`` and ``D`` and its heads of the SSM
    state ``[L, B/D, H/M, P, N]``, none all-gathered; the conv state
    gathered once and cut to the rank's channels ``[x_r | B | C]``."""
    ranks, _, _ = runs
    D, M = shape
    cfg = _cfg(arch)
    whole = dict(flatten_with_paths(tm.abstract(cfg)))
    dm = mamba2_dims(cfg)
    for r in ranks:
        got = r["holdings"][shape][arch]
        for n in MAMBA_LOCAL:
            p = f"blocks/mamba/{n}"
            assert got["params"][p] == (_split_shape(
                p, tuple(whole[p].shape), M), 0), (p, got["params"][p])
        L = cfg.num_layers
        assert got["cache"]["ssm"] == ((L, SB // D, dm["H"] // M, dm["P"],
                                        dm["N"]), 0)
        assert got["cache"]["conv"] == ((L, SB // D, cfg.conv_width - 1,
                                         dm["di"] // M + 2 * dm["N"]), 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_analyzer_counts_two_all_reduces_per_mamba2_layer(runs, arch):
    """``analyze`` of the loss forward on (2, 2): per Mamba2 layer one
    all-reduce for the gated norm's sum of squares and one for
    ``out_proj``'s partial sums; zamba2's shared attention two per
    application (attention and MLP); the embedding's and the CE's four;
    no all-gather.  Each rank's argument, peak temporary bytes and FLOPs
    are below the gathered compute's."""
    ranks, _, _ = runs
    cfg = _cfg(arch)
    apps = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    for r in ranks:
        loc = r["locality"][arch]
        assert loc["tp", "forward"]["counts"] == {
            "all-reduce": 2 * cfg.num_layers + 2 * apps + 4}
        for kind in ("forward", "step"):
            mine, whole = loc["tp", kind], loc["gathered", kind]
            assert whole["counts"] == {}
            assert mine["arguments"] < whole["arguments"], kind
            assert mine["temporaries"] < whole["temporaries"], kind
            assert mine["flops"] < whole["flops"], kind


def test_a_config_whose_heads_the_model_axis_does_not_divide_is_whole(runs):
    """2 SSM heads on 4 model ranks: no Mamba2 leaf is split, and the
    step equals the one-rank step."""
    ranks, _, _ = runs
    arch, _, over = WHOLE
    ms, params, grads = one_rank_train(arch, over, 1)
    for r in ranks:
        out = r["whole"][(1, 4), arch, False]
        local, summed = out["tp"]
        assert not {p for p in local | summed if "mamba" in p}
        m, = out["metrics"]
        assert abs(m["total_loss"] - ms[0]["total_loss"]) <= TOL
    _assert_params_close(ranks[0]["whole"][(1, 4), arch, False]["params"],
                         params, grads)


def test_the_split_gated_norm_on_the_ranks_equals_the_whole_row(runs):
    """Each of 4 model ranks normalises its quarter of the columns with
    the sum of squares summed over 'model' (``tp.model_summer``); the
    quarters side by side equal the whole row's norm, and their
    gradients autograd's of the whole row (the sum's backward summed
    over the ranks too)."""
    ranks, _, z = runs
    y, zz, w = (torch.from_numpy(z[k]).requires_grad_(True)
                for k in ("y", "z", "w"))
    out = gated_rmsnorm_ref(y, zz, w, 1e-6)
    torch.sum(out * torch.from_numpy(z["r"])).backward()
    got = sorted((r["norm"] for r in ranks), key=lambda h: h["model"])
    cat = {k: torch.cat([h[k] for h in got], -1)
           for k in ("out", "dy", "dz", "dw")}
    close(cat["out"], out.detach().numpy(), "f32")
    close(cat["dy"], y.grad.numpy(), "f32")
    close(cat["dz"], zz.grad.numpy(), "f32")
    close(cat["dw"], w.grad.numpy(), "f32",
          terms=dw_terms(torch.from_numpy(z["r"]), (y * torch.nn.functional
                         .silu(zz)).detach()))


def test_the_norms_sum_over_model_holds_on_another_thread(runs):
    """``tp.model_summer()`` binds the 'model' group where it is taken:
    called on a thread that does not see the context (autograd runs a
    CUDA backward on its own thread, where the split gated norm's
    Function sums its second partial), it still sums over the ranks."""
    ranks, _, z = runs
    want = torch.from_numpy(z["y"]).sum(-1)
    for r in ranks:
        h = r["norm"]
        assert h["thread_context"] is None
        assert torch.allclose(h["thread_sum"], want, atol=1e-5)


# --- without ranks -----------------------------------------------------------

_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _draw(dtype, seed=0):
    r = np.random.default_rng(seed)
    a = [r.normal(0, s, shp).astype(np.float32) for s, shp in
         ((1, (4, 3, 48)), (2, (4, 3, 48)), (0.1, (48,)), (1, (4, 3, 48)))]
    a[2] += 1
    return [torch.from_numpy(x).to(_DT[dtype]) for x in a]


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_the_split_gated_norm_plain_version_equals_the_whole_row(M, dtype):
    """M column blocks of a row: each block's ``gated_rmsnorm_sumsq_ref``,
    summed, then ``gated_rmsnorm_scale_ref`` per block, side by side,
    equal ``gated_rmsnorm_ref`` of the whole row (f32 1e-6, bf16 one
    ulp: the sum of squares is added in another order); each block's
    ``gated_rmsnorm_dot_ref``, summed, then
    ``gated_rmsnorm_scale_bwd_ref`` per block give autograd's gradient of
    the whole row (the bounds of ``norm_grad_checks.py``: dy and dz four
    bf16 roundings, dw one, f32 dw at its sum's scale)."""
    y, z, w, dout = _draw(dtype)
    d = y.shape[-1]
    blocks = [slice(i * d // M, (i + 1) * d // M) for i in range(M)]
    ss = sum(gated_rmsnorm_sumsq_ref(y[..., b], z[..., b]) for b in blocks)
    out = torch.cat([gated_rmsnorm_scale_ref(y[..., b], z[..., b], w[b], ss,
                                             d) for b in blocks], -1)
    assert out.dtype == y.dtype
    close(out, gated_rmsnorm_ref(y, z, w).float().numpy(), dtype)
    dot = sum(gated_rmsnorm_dot_ref(dout[..., b], y[..., b], z[..., b], w[b])
              for b in blocks)
    parts = [gated_rmsnorm_scale_bwd_ref(dout[..., b], y[..., b], z[..., b],
                                         w[b], ss, dot, d) for b in blocks]
    dy, dz, dw = (torch.cat([p[i] for p in parts], -1) for i in range(3))
    leaves = [t.clone().requires_grad_(True) for t in (y, z, w)]
    gated_rmsnorm_ref(*leaves).backward(dout)
    terms = dw_terms(dout, y * torch.nn.functional.silu(z))
    close(dy, leaves[0].grad.float().numpy(), dtype, ulps=4)
    close(dz, leaves[1].grad.float().numpy(), dtype, ulps=4)
    close(dw, leaves[2].grad.float().numpy(), dtype, terms=terms)


def test_the_split_gated_norm_outside_the_context_is_the_whole_norm():
    """One block: ``gated_rmsnorm_split_ref`` with ``tp.model_summer()``
    outside the context (the identity) is the whole row's norm, and its
    autograd gradient the whole row's."""
    y, z, w, dout = _draw("f32", 3)
    summer = tp.model_summer()
    assert tp.current_tp() is None and summer(y) is y
    leaves = [t.clone().requires_grad_(True) for t in (y, z, w)]
    out = gated_rmsnorm_split_ref(*leaves, y.shape[-1], summer)
    out.backward(dout)
    want = [t.clone().requires_grad_(True) for t in (y, z, w)]
    ref = gated_rmsnorm_ref(*want)
    ref.backward(dout)
    close(out.detach(), ref.detach().numpy(), "f32")
    for a, b in zip(leaves, want):
        close(a.grad, b.grad.numpy(), "f32",
              terms=dw_terms(dout, y * torch.nn.functional.silu(z))
              if a.dim() == 1 else None)


def test_mamba_columns_of_mamba2_780m_at_16_ranks():
    """mamba2-780m at M = 16: ``in_proj``'s 6,448 columns give each rank
    192 z, 192 x, the 256 of B and C and 3 dt columns (643), every z, x
    and dt column on exactly one rank; the conv's 3,328 channels give it
    192 x and the 256 B and C channels."""
    dm = mamba2_dims(get_config("mamba2-780m"))
    assert dm["in_dim"] == 6448 and dm["conv_ch"] == 3328
    seen = np.zeros(dm["in_dim"], int)
    seen_ch = np.zeros(dm["conv_ch"], int)
    for r in range(16):
        cols, chans = tp.mamba_columns(r, 16, dm)
        idx = np.concatenate([np.arange(a, b) for a, b in cols])
        assert len(idx) == 643
        seen[idx] += 1
        ch = np.concatenate([np.arange(a, b) for a, b in chans])
        assert len(ch) == 192 + 256
        seen_ch[ch] += 1
        t = torch.arange(dm["in_dim"])
        assert torch.equal(tp.take_columns(t, cols), torch.from_numpy(idx))
    bc = slice(2 * dm["di"], 2 * dm["di"] + 2 * dm["N"])
    assert (seen[bc] == 16).all()
    assert (np.delete(seen, np.arange(bc.start, bc.stop)) == 1).all()
    assert (seen_ch[dm["di"]:] == 16).all() and (seen_ch[:dm["di"]] == 1).all()


@pytest.mark.parametrize("arch,mesh,split", [
    ("mamba2-780m", (16, 16), True), ("zamba2-2.7b", (16, 16), True),
    ("mamba2-780m", (2, 32), False), ("zamba2-2.7b", (4, 64), False)],
    ids=lambda x: _ids(x) if isinstance(x, tuple) else str(x))
def test_tp_leaves_name_the_mamba2_leaves_where_the_axis_divides_the_heads(
        arch, mesh, split):
    """At the full configs: 48 and 80 SSM heads split over 16 model ranks
    (local: ``out_proj``, ``norm_w``, ``dt_bias``, ``A_log``, ``D``;
    summed: ``in_proj``, ``conv_w``, ``conv_b``), not over 32 or 64."""
    cfg = get_config(arch)
    m = MeshShape({"data": mesh[0], "model": mesh[1]})
    local, summed = tp_leaves(cfg, param_specs(cfg, tm.abstract(cfg), m,
                                               kind="train"), m)
    mine = {f"blocks/mamba/{n}" for n in MAMBA_LOCAL}
    cols = {f"blocks/mamba/{n}" for n in MAMBA_COLUMNS}
    assert (mine <= local and cols <= summed) == split
    assert bool({p for p in local | summed if "mamba" in p}) == split
