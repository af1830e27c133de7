"""The tensor-parallel train step (``repro_torch.train.sharded`` under
``models/tp.py``) over 4 gloo ranks, on a (2, 2) and a (1, 4) (data,
model) mesh, two steps from the seed-0 params of each attention family's
smoke config in f32: qwen3-0.6b (at M = 4 its 2 kv heads take the
replicated-KV route), gemma2, whisper, pixtral, and qwen3-moe with and
without expert parallelism, each against the port's one-rank step (the
MoE on (2, 2) routes each data shard on its own: held to the EP step and
to JAX's), the dense and the EP runs also against the JAX launcher's
sharded step under ``train_shardings`` on 4 host devices; the compute
tensors each rank holds; and ``step_analyzer.analyze`` of the step's
loss and gradients against the gathered compute.  One spawn of the ranks
and one JAX process per mesh and run serve the whole file.

The bound is 1e-4 on losses and on every parameter whose gradient is
clear of AdamW's epsilon (1e-8): an element whose gradient is below
``CLEAR`` moves by lr * g / (|g| + eps), where the last bits of g (which
another summation order changes) move it by up to a step's size (whisper
has one, |g| 4.5e-9, that moves 1.3e-4 further on the mesh); those are
held to 2 lr per step."""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import save
from repro_torch.configs import TrainConfig, get_config
from repro_torch.models import model as tm
from repro_torch.train import optim
from repro_torch.utils.tree import flatten_with_paths

sys.path.insert(0, os.path.dirname(__file__))
import scaleout_ranks  # noqa: E402

torch.set_num_threads(1)
B, S, STEPS = 4, 16, 2
DENSE, MOE = "qwen3-0.6b", "qwen3-moe-30b-a3b"
NO_DROP = {"capacity_factor": 4.0}
SHAPES = [(2, 2), (1, 4)]
RUNS = [(DENSE, False, {}), ("gemma2-27b", False, {}),
        ("whisper-large-v3", False, {}), ("pixtral-12b", False, {}),
        (MOE, False, NO_DROP), (MOE, True, NO_DROP)]
#: (mesh, arch, ep) held to JAX's sharded step
JAX_RUNS = [(shape, arch, ep) for shape in SHAPES
            for arch, ep, _ in (RUNS[0], RUNS[-1])]
TOL, CLEAR = 1e-4, 1e-6
LR = scaleout_ranks.STEP_TC["learning_rate"]


def _cfg(arch, over):
    return get_config(arch, smoke=True).replace(**scaleout_ranks.F32, **over)


def _over(arch):
    return NO_DROP if arch == MOE else {}


def _jax_step(tmp, shape, arch, ep):
    name = f"{arch}_{shape[0]}x{shape[1]}_{int(ep)}"
    over = _over(arch)
    tc = TrainConfig(**scaleout_ranks.STEP_TC)
    p = tm.init(_cfg(arch, over), torch.Generator().manual_seed(0), "cpu")
    o = optim.init_opt_state(p, tc)
    save(str(tmp / f"ckpt_{name}"), 0, {"params": p, "m": o.m, "v": o.v,
                                        "count": o.count})
    np.savez(tmp / f"in_{name}.npz", arch=arch, ckpt=str(tmp / f"ckpt_{name}"),
             B=B, S=S, steps=STEPS, ep=ep, microbatch=0, masked=False,
             mesh=np.array(shape), **over)
    return scaleout_ranks.jax_process("sharded_step", tmp / f"in_{name}.npz",
                                      tmp / f"jax_{name}.npz")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    procs = {key: (_jax_step(tmp, *key), key) for key in JAX_RUNS}
    try:
        ranks = scaleout_ranks.spawn("tp_train_checks_rank", tmp, SHAPES,
                                     RUNS, B, S, STEPS, DENSE)
    finally:
        ref = {key: scaleout_ranks.jax_result(
            p, tmp / f"jax_{k[1]}_{k[0][0]}x{k[0][1]}_{int(k[2])}.npz")
            for key, (p, k) in procs.items()}
    return ranks, ref


_ONE_RANK = {}


def one_rank(arch):
    """The one-rank steps of ``arch``: metrics, final params and each
    step's gradients (cached for the file)."""
    if arch not in _ONE_RANK:
        _ONE_RANK[arch] = scaleout_ranks.one_rank_steps(
            arch, _over(arch), B, S, STEPS, grads=True)
    return _ONE_RANK[arch]


def _run(ranks, shape, arch, ep):
    outs = [r["train"][shape, arch, ep] for r in ranks]
    for o in outs[1:]:
        assert o["metrics"] == outs[0]["metrics"]
    return outs[0]


def _assert_params_close(got, want, grads):
    """Every leaf within TOL where each step's one-rank gradient is clear
    of AdamW's epsilon, within 2 lr per step elsewhere."""
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
        assert float(d.max()) <= 2 * LR * STEPS, (path, float(d.max()))


ONE_RANK_CASES = [(shape, arch, ep) for shape in SHAPES
                  for arch, ep, _ in RUNS
                  if not (arch == MOE and shape == (2, 2))]


@pytest.mark.parametrize("shape,arch,ep", ONE_RANK_CASES,
                         ids=lambda x: (f"{x[0]}x{x[1]}" if isinstance(
                             x, tuple) else str(x)))
def test_tp_step_equals_the_one_rank_step(runs, shape, arch, ep):
    """Loss and grad norm of each step within 1e-4, every parameter
    after the last by the bound above (on (1, 4) the MoE's one data shard
    routes the global batch, so with or without expert parallelism it is
    the one-rank step)."""
    ranks, _ = runs
    got = _run(ranks, shape, arch, ep)
    ms, params, grads = one_rank(arch)
    for m, r in zip(got["metrics"], ms):
        assert abs(m["total_loss"] - r["total_loss"]) <= TOL, (m, r)
        assert abs(m["grad_norm"] - r["grad_norm"]) <= TOL * r["grad_norm"]
    _assert_params_close(ranks[0]["train"][shape, arch, ep]["params"],
                         params, grads)


@pytest.mark.parametrize("shape,arch,ep", JAX_RUNS,
                         ids=lambda x: (f"{x[0]}x{x[1]}" if isinstance(
                             x, tuple) else str(x)))
def test_tp_step_equals_jax_sharded_step(runs, shape, arch, ep):
    """Loss, aux and grad norm of each step within 1e-4 of JAX's sharded
    step (GSPMD's partition of the same rule table), every parameter
    after the last by the bound above (the clear elements those of the
    one-rank gradients)."""
    ranks, ref = runs
    ref = ref[shape, arch, ep]
    got = _run(ranks, shape, arch, ep)
    for i, m in enumerate(got["metrics"]):
        assert abs(m["total_loss"] - float(ref[f"loss{i}"])) <= TOL
        assert abs(m["aux_loss"] - float(ref[f"aux{i}"])) <= TOL
        gn = float(ref[f"gnorm{i}"])
        assert abs(m["grad_norm"] - gn) <= TOL * gn
    params = ranks[0]["train"][shape, arch, ep]["params"]
    want = {p: ref[f"step{STEPS - 1}/{p}"]
            for p, _ in flatten_with_paths(params)}
    _assert_params_close(params, want, one_rank(arch)[2])


def test_moe_on_2x2_with_and_without_ep_agree(runs):
    """On (2, 2) each data shard routes its own tokens with or without
    expert parallelism: the same function, the EP one held to JAX's."""
    ranks, _ = runs
    a = _run(ranks, (2, 2), MOE, False)
    b = _run(ranks, (2, 2), MOE, True)
    for x, y in zip(a["metrics"], b["metrics"]):
        assert abs(x["total_loss"] - y["total_loss"]) <= 1e-5
    for (p, u), (_, v) in zip(
            flatten_with_paths(ranks[0]["train"][(2, 2), MOE, False]
                               ["params"]),
            flatten_with_paths(ranks[0]["train"][(2, 2), MOE, True]
                               ["params"])):
        assert float((u - v).abs().max()) <= TOL, p


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_computes_its_share_of_the_split_leaves(runs, shape):
    """Every split leaf's compute tensor is 1/M of the whole along the
    rule table's 'model' dim; at M = 4 qwen3's 2 kv heads are computed
    whole (the replicated-KV route, gradients summed over 'model'); and
    taking the compute tensors gathers exactly the leaves computed whole
    that are stored split: no split leaf is gathered."""
    ranks, _ = runs
    M = shape[1]
    for arch, ep, over in RUNS:
        cfg = _cfg(arch, over)
        whole = dict(flatten_with_paths(tm.abstract(cfg)))
        for r in ranks:
            out = r["train"][shape, arch, ep]
            local, summed = out["tp"]
            names = {p.rsplit("/", 1)[-1] for p in local}
            assert {"wq", "wo", "embed"} <= names, (arch, names)
            if cfg.d_ff:
                assert {"wi_gate", "wi_up"} <= names
            for p in local:
                got, full = out["compute"][p], tuple(whole[p].shape)
                dim = -1 if p.rsplit("/", 1)[-1] in (
                    "wq", "wk", "wv", "wi_gate", "wi_up", "lm_head") else -2
                want = list(full)
                want[dim] //= M
                assert got == tuple(want), (arch, p, got, full)
            kv_split = cfg.num_kv_heads % M == 0
            assert any(p.endswith("/wk") for p in local) == kv_split
            assert any(p.endswith("/wk") for p in summed) != kv_split
            stored = _stored_specs(arch, shape)
            assert out["gathered"] == {
                p for p in whole if p not in local and "model" in stored[p]
                and not (ep and p.endswith(("w_gate", "w_up", "w_down")))
            }, arch


def _stored_specs(arch, shape):
    """path -> the parts of the leaf's stored spec on a mesh of
    ``shape``."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import param_specs
    cfg = _cfg(arch, _over(arch))
    mesh = MeshShape(dict(zip(("data", "model"), shape)))
    return {p: tuple(s) for p, s in flatten_with_paths(param_specs(
        cfg, tm.abstract(cfg), mesh, kind="train"))}


def test_the_analyzer_sees_the_split_compute(runs):
    """``analyze`` of qwen3's loss on (2, 2): per layer forward, one
    all-reduce for the attention block's ``wo`` and one for the MLP's,
    and the embedding's and the CE's three (max, sum of exponentials,
    gold logit); the step's backward adds each block input's gradient,
    the LM head's input's, and under remat="full" each layer's attention
    all-reduce again (the recompute stops at the last tensor the backward
    needs, before the MLP's); no all-gather.  Each rank's argument and peak temporary bytes
    are below the gathered compute's, which issues no collective."""
    ranks, _ = runs
    for r in ranks:
        loc = r["locality"]
        L = loc["layers"]
        assert loc["remat"] == "full"
        fwd, step = loc["tp", "forward"], loc["tp", "step"]
        assert fwd["counts"] == {"all-reduce": 2 * L + 4}, fwd["counts"]
        assert step["counts"] == {"all-reduce": (2 * L + 4) + L + 2 * L
                                  + 1}, step["counts"]
        for kind in ("forward", "step"):
            tp, whole = loc["tp", kind], loc["gathered", kind]
            assert whole["counts"] == {}
            assert tp["arguments"] < whole["arguments"], kind
            assert tp["temporaries"] < whole["temporaries"], kind
            assert tp["flops"] < whole["flops"], kind
