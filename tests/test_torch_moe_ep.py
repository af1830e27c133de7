"""The port's expert-parallel MoE (``repro_torch.models.moe_ep``) over 4
gloo ranks on a (2, 2) (data, model) mesh against the JAX package's
``moe_ffn_ep`` on 4 host devices: y within 1e-5, aux, the gradients of x
and of all four weights (sum(y * r) + 0.37 * aux) within 1e-4, and the
same dropped assignments, at capacity factor 32 (nothing drops) and 1.0
(per-source-shard capacity drops), with ``tp_dispatch`` off and on.
Also: at factor 32 the EP path equals the port's dense ``moe_ffn``; the
remat recompute of a layer re-enters the mesh when autograd runs it on
another thread; the model's MoE block takes the EP branch under the
context.  One spawn of the ranks and one JAX process serve the whole
file."""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.models import moe_ep
from repro_torch.models.moe import moe_ffn
from repro_torch.utils.tree import tree_leaves

sys.path.insert(0, os.path.dirname(__file__))
import scaleout_ranks  # noqa: E402

torch.set_num_threads(1)
N, d, E, f, k = 64, 16, 8, 24, 2
CFS = (32.0, 1.0)
CASES = [(cf, tp) for cf in CFS for tp in (False, True)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    rng = np.random.default_rng(0)
    # tokens with a common component, so the router favours a few experts
    # and every shard's dispatch overflows at factor 1.0
    z = {"x": rng.normal(1, 1, (N, d)), "r": rng.normal(0, 1, (N, d)),
         "wr": rng.normal(0, 1.0, (d, E)), "wg": rng.normal(0, 0.3, (E, d, f)),
         "wu": rng.normal(0, 0.3, (E, d, f)),
         "wd": rng.normal(0, 0.3, (E, f, d))}
    z = {n: a.astype(np.float32) for n, a in z.items()}
    np.savez(tmp / "in.npz", k=k, cfs=np.asarray(CFS), **z)
    proc = scaleout_ranks.jax_process("moe_ep", tmp / "in.npz",
                                      tmp / "jax.npz")
    try:
        ranks = scaleout_ranks.spawn("moe_ep_rank", tmp, str(tmp / "in.npz"),
                                     k, CASES)
    finally:
        ref = scaleout_ranks.jax_result(proc, tmp / "jax.npz")
    return z, ranks, ref


def _assemble(ranks, case, name):
    """The global array of ``name`` from the ranks' shards (x, y: rows by
    data; experts: E by data, f by model; the router: replicated), after
    checking the replicas agree."""
    by = {r["coord"]: r["out"][case][name] for r in ranks}
    if name in ("y", "x"):
        for di in (0, 1):
            assert torch.equal(by[(di, 0)], by[(di, 1)]), name
        return torch.cat([by[(0, 0)], by[(1, 0)]]).numpy()
    if name in ("wr", "aux", "dropped"):
        for v in by.values():
            assert torch.equal(v, by[(0, 0)]), name
        return by[(0, 0)].numpy()
    fdim = 1 if name == "wd" else 2
    return torch.cat([torch.cat([by[(di, mi)] for mi in (0, 1)], fdim)
                      for di in (0, 1)]).numpy()


@pytest.mark.parametrize("cf,tp", CASES, ids=lambda v: str(v))
def test_output_and_aux_equal_jax(runs, cf, tp):
    _, ranks, ref = runs
    key = f"cf{cf}_tp{int(tp)}"
    np.testing.assert_allclose(_assemble(ranks, (cf, tp), "y"),
                               ref[key + "_y"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(_assemble(ranks, (cf, tp), "aux"),
                               ref[key + "_aux"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["x", "wr", "wg", "wu", "wd"])
@pytest.mark.parametrize("cf,tp", CASES, ids=lambda v: str(v))
def test_gradients_equal_jax(runs, cf, tp, name):
    _, ranks, ref = runs
    np.testing.assert_allclose(_assemble(ranks, (cf, tp), name),
                               ref[f"cf{cf}_tp{int(tp)}_g{name}"],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("cf,tp", CASES, ids=lambda v: str(v))
def test_the_same_assignments_drop(runs, cf, tp):
    """The shards' mean drop fraction times the N·k assignments is the
    count JAX's per-shard dispatch drops; factor 1.0 drops some, 32
    none."""
    _, ranks, ref = runs
    frac = float(_assemble(ranks, (cf, tp), "dropped"))
    count = int(ref[f"cf{cf}_tp{int(tp)}_dropped"])
    assert round(frac * N * k) == count
    assert (count > 0) == (cf == 1.0), count


@pytest.mark.parametrize("tp", [False, True])
def test_ep_equals_the_dense_path_where_nothing_drops(runs, tp):
    z, ranks, _ = runs
    dense = moe_ffn(*(torch.from_numpy(z[n]) for n in
                      ("x", "wr", "wg", "wu", "wd")),
                    k=k, capacity_factor=32.0).y.numpy()
    np.testing.assert_allclose(_assemble(ranks, (32.0, tp), "y"), dense,
                               atol=1e-5, rtol=0)


class _FakeMesh:
    """A mesh whose groups are never used (nothing is launched)."""


def test_the_context_is_thread_local_and_nests():
    assert moe_ep.current_ep_mesh() is None
    m = _FakeMesh()
    with moe_ep.ep_mesh_context(m, tp_dispatch=True):
        assert moe_ep.current_ep_mesh() == (m, "data", "model", (), True)
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            moe_ep.current_ep_mesh()))
        t.start()
        t.join(timeout=10)
        assert seen == [None]
        with moe_ep.ep_mesh_context(m, extra_batch_axes=["pod"]):
            assert moe_ep.current_ep_mesh()[3] == ("pod",)
        assert moe_ep.current_ep_mesh()[4] is True
    assert moe_ep.current_ep_mesh() is None


def test_remat_recompute_reenters_the_mesh_on_another_thread(monkeypatch):
    """A checkpointed layer run under the context, its backward called
    from a thread that has none (as autograd's device thread on the
    card): the recompute still sees the forward's context."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32", remat="full")
    seen = []
    monkeypatch.setattr(tm, "moe_ffn_ep", lambda *a, **kw: (
        seen.append(moe_ep.current_ep_mesh()), moe_ffn(*a, **kw))[1])
    p = tm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(3, cfg.vocab_size, (2, 8))
    for t in tree_leaves(p):
        t.requires_grad_(True)
    m = _FakeMesh()
    with moe_ep.ep_mesh_context(m):
        h, aux = tm.forward_train(p, cfg, {"tokens": toks, "labels": toks})
    n_fwd = len(seen)
    assert n_fwd == cfg.num_layers
    t = threading.Thread(target=lambda: (h.sum() + aux).backward())
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert len(seen) == 2 * cfg.num_layers
    assert all(s is not None and s[0] is m for s in seen)
    assert all(x.grad is not None for x in p["blocks"]["moe"].values())
