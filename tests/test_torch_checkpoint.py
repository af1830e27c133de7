"""The port's checkpoints, in the JAX package's format: each package
restores what the other wrote, bit for bit (f32, bf16 through its uint16
view, the int32 count, nested dicts and the optimizer's NamedTuple);
keep-N; the async writer; resume equal to an uninterrupted run (the
port's twin of test_checkpoint.py's); missing and mismatched leaves
refused."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.configs import TrainConfig as JTrainConfig
from repro.train import optim as j_optim
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step, restore, save)
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import model as tm
from repro_torch.models.params import from_jax
from repro_torch.train import optim
from repro_torch.train.step import build_train_step
from repro_torch.utils.tree import flatten_with_paths, tree_leaves

torch.set_num_threads(1)


def _j_tree(seed=0):
    """A JAX tree with every leaf kind a train checkpoint holds."""
    rng = np.random.default_rng(seed)
    p = {"a": jnp.asarray(rng.normal(0, 1, (4, 8)), jnp.float32),
         "nested": {"b": jnp.asarray(rng.normal(0, 1, (3,)), jnp.bfloat16),
                    "c": jnp.asarray(rng.normal(0, 1, (2, 2)), jnp.float32)}}
    opt = j_optim.init_opt_state(p, JTrainConfig())
    opt = opt._replace(count=jnp.asarray(7, jnp.int32))
    return {"params": p, "opt": opt}


def _t_tree(j):
    """The same tree in the port's types (an ``optim.OptState``)."""
    return {"params": from_jax(jax.tree.map(np.asarray, j["params"])),
            "opt": optim.OptState(
                m=from_jax(jax.tree.map(np.asarray, j["opt"].m)),
                v=from_jax(jax.tree.map(np.asarray, j["opt"].v)),
                count=torch.tensor(int(j["opt"].count), dtype=torch.int32))}


def _bits(x):
    a = np.asarray(x) if not isinstance(x, torch.Tensor) else (
        x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
        else x.numpy())
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(t_tree, j_tree):
    tl, jl = flatten_with_paths(t_tree), j_ckpt.flatten_with_paths(j_tree)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (p, t), (_, j) in zip(tl, jl):
        assert str(t.dtype).split(".")[-1] == str(np.asarray(j).dtype), p
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=p)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    j = _j_tree()
    j_ckpt.save(str(tmp_path), 4, j)
    t, step = restore(str(tmp_path), _t_tree(_j_tree(seed=1)))
    assert step == 4 and isinstance(t["opt"], optim.OptState)
    _same(t, j)


def test_port_checkpoint_restores_in_jax(tmp_path):
    j = _j_tree()
    save(str(tmp_path), 9, _t_tree(j))
    assert j_ckpt.latest_step(str(tmp_path)) == 9
    restored, step = j_ckpt.restore(str(tmp_path), _j_tree(seed=1))
    assert step == 9
    _same(_t_tree(j), restored)


def test_files_are_the_jax_format(tmp_path):
    """Keys are the JAX package's paths, bf16 stored as ``bf16::`` +
    path in a uint16 view; the manifest names the step and the file."""
    save(str(tmp_path), 3, _t_tree(_j_tree()))
    with np.load(tmp_path / "ckpt_00000003.npz") as f:
        keys = sorted(f.files)
        assert f["bf16::params/nested/b"].dtype == np.uint16
    assert "opt/count" in keys and "params/a" in keys
    assert latest_step(str(tmp_path)) == 3
    assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))


def test_keep_k_gc(tmp_path):
    t = _t_tree(_j_tree())
    for s in range(6):
        save(str(tmp_path), s, t, keep=2)
    ckpts = sorted(f for f in os.listdir(tmp_path) if f.startswith("ckpt_"))
    assert ckpts == ["ckpt_00000004.npz", "ckpt_00000005.npz"]
    assert latest_step(str(tmp_path)) == 5


def test_restore_refuses_missing_and_mismatched_leaves(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), {"a": torch.zeros(2)})
    save(str(tmp_path), 0, {"a": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path), {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        restore(str(tmp_path), {"b": torch.zeros(2, 2)})


def test_restore_casts_to_the_template_and_places_it(tmp_path):
    """Each leaf takes its template's dtype, on ``device`` or, when that
    is None, its template's device (meta templates need a device)."""
    save(str(tmp_path), 1, {"a": torch.arange(4.0)})
    t, _ = restore(str(tmp_path), {"a": torch.zeros(4, dtype=torch.bfloat16)})
    assert t["a"].dtype == torch.bfloat16 and t["a"].tolist() == [0, 1, 2, 3]
    t, _ = restore(str(tmp_path), {"a": torch.empty(4, device="meta")},
                   device="cpu")
    assert t["a"].device.type == "cpu"


def test_async_checkpointer(tmp_path):
    """Each submit snapshots to host memory at once: later in-place
    changes of the tensors do not reach the file."""
    ck = AsyncCheckpointer(str(tmp_path), keep=3)
    t = _t_tree(_j_tree())
    want = t["params"]["a"].clone()
    for s in range(3):
        ck.submit(s, t)
    t["params"]["a"].add_(1.0)
    ck.close()
    assert latest_step(str(tmp_path)) == 2
    restored, _ = restore(str(tmp_path), t)
    assert torch.equal(restored["params"]["a"], want)


def test_restore_resume_matches_uninterrupted_training(tmp_path):
    """Save at step 3, restore, continue to 6: the same parameters as an
    uninterrupted 6-step run (optimizer state and data determinism)."""
    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    tc = TrainConfig(learning_rate=1e-3)
    shape = ShapeConfig("t", "train", 16, 2)
    dc = DataConfig()
    step_fn = build_train_step(cfg, tc)

    def run(params, opt, lo, hi):
        for i in range(lo, hi):
            batch = {k: torch.from_numpy(v) for k, v in
                     make_batch(cfg, shape, dc, i).items()}
            params, opt, _ = step_fn(params, opt, batch)
        return params, opt

    p0 = tm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    o0 = optim.init_opt_state(p0, tc)
    pu, _ = run(p0, o0, 0, 6)
    p3, o3 = run(p0, o0, 0, 3)
    save(str(tmp_path), 3, {"params": p3, "m": o3.m, "v": o3.v,
                            "count": o3.count})
    tmpl = {"params": p0, "m": o0.m, "v": o0.v, "count": o0.count}
    restored, step = restore(str(tmp_path), tmpl)
    opt_r = optim.OptState(m=restored["m"], v=restored["v"],
                           count=restored["count"])
    pr, _ = run(restored["params"], opt_r, step, 6)
    for a, b in zip(tree_leaves(pu), tree_leaves(pr)):
        assert torch.equal(a, b)


def test_elastic_restore_onto_a_2x2_mesh(tmp_path):
    """A checkpoint saved without a mesh resumes onto a (2, 2) (data,
    model) mesh of 4 gloo ranks (``restore(..., shardings=)``): a tree of
    shardings and one sharding for every leaf; each rank holds its slice
    of every leaf as a DTensor at the spec's placements, whose whole
    value is the saved one (bf16 bit for bit)."""
    import sys
    from torch.distributed.tensor import Replicate, Shard
    sys.path.insert(0, os.path.dirname(__file__))
    import scaleout_ranks
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones(8),
            "h": torch.randn(4, 6, generator=torch.Generator().manual_seed(
                1)).to(torch.bfloat16)}
    save(str(tmp_path / "ckpt"), 1, tree)
    ranks = scaleout_ranks.spawn("restore_rank", tmp_path,
                                 str(tmp_path / "ckpt"))
    R = Replicate()
    assert sorted(tuple(r["coord"]) for r in ranks) == [(0, 0), (0, 1),
                                                        (1, 0), (1, 1)]
    for r in ranks:
        di, mi = r["coord"]
        assert r["step"] == 1
        got = r["tree"]
        assert got["w"][1] == (R, Shard(1))
        assert torch.equal(got["w"][0], tree["w"][:, 4 * mi:4 * mi + 4])
        assert got["b"][1] == (R, R) and torch.equal(got["b"][0], tree["b"])
        assert got["h"][1] == (Shard(0), Shard(1))
        assert torch.equal(got["h"][0].view(torch.int16), tree["h"][
            2 * di:2 * di + 2, 3 * mi:3 * mi + 3].view(torch.int16))
        for name, leaf in tree.items():
            assert torch.equal(got[name][2].view(torch.int16)
                               if leaf.dtype == torch.bfloat16
                               else got[name][2],
                               leaf.view(torch.int16)
                               if leaf.dtype == torch.bfloat16 else leaf)
        one = r["one"]
        assert all(v[1] == (Shard(0), R) for v in one.values())
        assert torch.equal(one["w"][0], tree["w"][4 * di:4 * di + 4])
        assert torch.equal(one["b"][0], tree["b"][4 * di:4 * di + 4])
