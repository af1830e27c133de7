"""The port's sharded train step (``repro_torch.train.sharded``) over 4
gloo ranks on a (2, 2) (data, model) mesh, two steps from the seed-0
params: the dense smoke (qwen3-0.6b) against the port's one-rank step,
loss and every parameter within 1e-4 (test_distributed.py's bounds; the
one-rank step is held to ``jax.value_and_grad`` by the train parity
tests); the MoE smoke under expert parallelism (``moe_ffn_ep``, at a
capacity where nothing drops) against the JAX launcher's own sharded
step under ``ep_mesh_context`` on 4 host devices, the same function
(its aux loss is the mean of the shards', JAX's ``pmean``), and, with the
aux term's weight at 0, against the one-rank step; the MoE without
expert parallelism (each data shard routing its own tokens) equal to
it; the dense smoke with ``microbatch`` set and a loss mask that counts
different tokens in each microbatch against the one-rank step and JAX's
sharded step with the same microbatch, and the ``ValueError`` of a
microbatch that does not split over the data ranks; the stored
placements those of the rule tables.  One spawn of the ranks and two
JAX processes serve the whole file."""
import os
import sys

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

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
#: every expert can take every token of a shard (E / k): nothing drops
NO_DROP = {"capacity_factor": 4.0}
#: the dense smoke accumulated over 2 microbatches of the global 4 rows
#: (one row per data rank each), on batches whose rows count 15, 12, 9
#: and 6 tokens (``scaleout_ranks.masked``)
MICRO = {"microbatch": 2, "masked": True}
RUNS = [(DENSE, False, {}), (MOE, True, NO_DROP),
        (MOE, True, dict(NO_DROP, router_aux_weight=0.0)),
        (MOE, False, NO_DROP), (DENSE, False, {}, MICRO)]
#: a microbatch of 1 row cannot split over the 2 data ranks
UNEVEN_MB = 1


def _cfg(arch, over):
    return get_config(arch, smoke=True).replace(**scaleout_ranks.F32, **over)


def one_rank(arch, over, opts=None):
    return scaleout_ranks.one_rank_steps(arch, over, B, S, STEPS, opts)


def _jax_step(tmp, name, arch, over, ep, microbatch=0, masked=False):
    """Start JAX's sharded step of ``arch`` from the port's seed-0
    checkpoint."""
    tc = TrainConfig(**scaleout_ranks.STEP_TC)
    p = tm.init(_cfg(arch, over), torch.Generator().manual_seed(0), "cpu")
    o = optim.init_opt_state(p, tc)
    save(str(tmp / f"ckpt_{name}"), 0, {"params": p, "m": o.m, "v": o.v,
                                        "count": o.count})
    np.savez(tmp / f"in_{name}.npz", arch=arch, ckpt=str(tmp / f"ckpt_{name}"),
             B=B, S=S, steps=STEPS, ep=ep, microbatch=microbatch,
             masked=masked, **over)
    return scaleout_ranks.jax_process("sharded_step", tmp / f"in_{name}.npz",
                                      tmp / f"jax_{name}.npz")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    procs = {"ep": _jax_step(tmp, "ep", MOE, NO_DROP, True),
             "micro": _jax_step(tmp, "micro", DENSE, {}, False, **MICRO)}
    try:
        out = scaleout_ranks.spawn("sharded_checks_rank", tmp, RUNS, B, S,
                                   STEPS, UNEVEN_MB)
    finally:
        ref = {k: scaleout_ranks.jax_result(p, tmp / f"jax_{k}.npz")
               for k, p in procs.items()}
    return [r["steps"] for r in out], ref, [r["uneven"] for r in out]


def _same_on_every_rank(ranks, i):
    ms = [r[i]["metrics"] for r in ranks]
    assert all(m == ms[0] for m in ms), ms
    return ms[0], ranks[0][i]["params"]


def _assert_params_close(got, want, tol=1e-4):
    for (path, a), (_, b) in zip(flatten_with_paths(got),
                                 flatten_with_paths(want), strict=True):
        b = torch.as_tensor(b)
        assert a.shape == b.shape, path
        assert float((a - b).abs().max()) <= tol, (
            path, float((a - b).abs().max()))


@pytest.mark.parametrize("i", [0, 2], ids=["dense", "moe-ep-no-aux"])
def test_sharded_step_equals_the_one_rank_step(runs, i):
    ranks, _, _ = runs
    arch, _, over = RUNS[i]
    ms, params = _same_on_every_rank(ranks, i)
    ref_ms, ref_p = one_rank(arch, over)
    for m, r in zip(ms, ref_ms):
        assert abs(m["total_loss"] - r["total_loss"]) <= 1e-4, (m, r)
        assert abs(m["grad_norm"] - r["grad_norm"]) <= 1e-4 * r["grad_norm"]
        assert m["tokens"] == r["tokens"] == B * S
    _assert_params_close(params, ref_p)


def test_ep_sharded_step_equals_jax_ep_step(runs):
    """Under expert parallelism the aux loss is the mean of the shards'
    (as JAX's ``pmean``), so the function is JAX's sharded EP step, not
    the one-rank step: loss, aux, grad norm and every parameter after
    each step."""
    ranks, ref, _ = runs
    ref = ref["ep"]
    ms, params = _same_on_every_rank(ranks, 1)
    for i, m in enumerate(ms):
        assert abs(m["total_loss"] - float(ref[f"loss{i}"])) <= 1e-4
        assert abs(m["aux_loss"] - float(ref[f"aux{i}"])) <= 1e-4
        # AdamW's step is blind to a gradient's scale: the norm is not
        gn = float(ref[f"gnorm{i}"])
        assert abs(m["grad_norm"] - gn) <= 1e-4 * gn
    want = {p: ref[f"step{STEPS - 1}/{p}"] for p, _ in
            flatten_with_paths(params)}
    for path, a in flatten_with_paths(params):
        d = float((a - torch.from_numpy(want[path])).abs().max())
        assert d <= 1e-4, (path, d)


def test_moe_without_ep_routes_each_shard_as_ep_does(runs):
    """Without expert parallelism each data shard runs the dense MoE on
    its own tokens: capacity and aux per shard, the EP step's function."""
    ranks, _, _ = runs
    ep_ms, ep_p = _same_on_every_rank(ranks, 1)
    ms, params = _same_on_every_rank(ranks, 3)
    for a, b in zip(ms, ep_ms):
        assert abs(a["total_loss"] - b["total_loss"]) <= 1e-5
        assert abs(a["aux_loss"] - b["aux_loss"]) <= 1e-5
    _assert_params_close(params, ep_p)


def test_the_state_follows_the_rule_tables(runs):
    """Parameters at ``param_specs(kind="train")``, moments at
    ``zero1_opt_specs`` (the data axis added to the largest free dim of
    a big leaf: at smoke size none is 16 MiB, so they equal)."""
    ranks, _, _ = runs
    R = Replicate()
    pl = ranks[0][1]["placements"]
    assert pl["blocks/attn/wq"] == ((R, Shard(2)), (R, Shard(2)))
    assert pl["blocks/attn/wo"] == ((R, Shard(1)), (R, Shard(1)))
    assert pl["blocks/moe/w_gate"][0] == (Shard(1), Shard(3))
    assert pl["blocks/moe/w_down"][0] == (Shard(1), Shard(2))
    assert pl["blocks/moe/w_router"][0] == (R, R)
    assert pl["embed"][0] == (R, Shard(0))
    for r in ranks:
        assert r[1]["placements"] == pl


def test_microbatched_sharded_step_equals_one_rank_and_jax(runs):
    """``tc.microbatch`` on the mesh: each microbatch's CE is the
    token-weighted mean over its own tokens (15 + 12 and 9 + 6 counted),
    the gradients their fp32 mean, the metrics the microbatches' mean:
    loss, grad norm and every parameter within 1e-4 of the port's
    one-rank step and of JAX's sharded step with the same microbatch."""
    ranks, ref, _ = runs
    ref = ref["micro"]
    ms, params = _same_on_every_rank(ranks, 4)
    one_ms, one_p = one_rank(DENSE, {}, MICRO)
    for i, (m, r) in enumerate(zip(ms, one_ms)):
        assert abs(m["total_loss"] - r["total_loss"]) <= 1e-4, (m, r)
        assert abs(m["total_loss"] - float(ref[f"loss{i}"])) <= 1e-4
        for gn in (r["grad_norm"], float(ref[f"gnorm{i}"])):
            assert abs(m["grad_norm"] - gn) <= 1e-4 * gn
        assert m["tokens"] == r["tokens"] == (15 + 12 + 9 + 6) / 2
    _assert_params_close(params, one_p)
    for path, a in flatten_with_paths(params):
        d = float((a - torch.from_numpy(ref[f"step{STEPS - 1}/{path}"]))
                  .abs().max())
        assert d <= 1e-4, (path, d)


def test_uneven_microbatch_raises(runs):
    _, _, uneven = runs
    for msg in uneven:
        assert msg is not None and f"microbatch {UNEVEN_MB}" in msg \
            and "2 data ranks" in msg, msg
