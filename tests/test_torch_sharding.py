"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's, spec for spec: every arch's parameters (train and serve),
ZeRO-1 moments, dense caches and train batch on the production meshes
(16x16 and 2x16x16, shape-only on both sides), the serving mesh 2x2 where
the H100's 80 GiB and the v5e's 16 GiB budgets decide FSDP differently,
and the conversion of specs to DTensor placements.  No process group is
needed: the rules read axis names and sizes only."""
import functools

import jax
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import DataConfig, make_batch
from repro.launch import sharding as j_shd
from repro.models import model as jm
from repro.utils.tree import flatten_with_paths as j_flatten
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_shd
from repro_torch.models import model as tm
from repro_torch.utils.tree import flatten_with_paths as t_flatten


class FakeMesh:
    """Shape-only stand-in for jax.Mesh (as in tests/test_sharding.py)."""

    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
KINDS = ("param_train", "param_serve", "zero1", "cache", "batch")


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(JAX cfg, JAX abstract params, JAX abstract cache, port cfg, port
    abstract params, port abstract cache, a global train batch of 256)."""
    jc, tc = j_get_config(arch), t_get_config(arch)
    batch = make_batch(jc, ShapeConfig("t", "train", 8, 256), DataConfig(),
                       0)
    return (jc, jm.abstract(jc), jm.init_cache(jc, 128, 1024,
                                               abstract_only=True),
            tc, tm.abstract(tc), tm.init_cache(tc, 128, 1024,
                                               abstract_only=True), batch)


def _specs(kind, arch, jmesh, tmesh):
    jc, jp, jcache, tc, tp, tcache, batch = _trees(arch)
    if kind in ("param_train", "param_serve"):
        k = kind.split("_")[1]
        return (j_shd.param_specs(jc, jp, jmesh, kind=k),
                t_shd.param_specs(tc, tp, tmesh, kind=k,
                                  hbm_bytes=j_shd.HBM_BYTES))
    if kind == "zero1":
        return (j_shd.zero1_opt_specs(j_shd.param_specs(jc, jp, jmesh),
                                      jp, jmesh),
                t_shd.zero1_opt_specs(t_shd.param_specs(tc, tp, tmesh),
                                      tp, tmesh))
    if kind == "cache":
        return (j_shd.cache_specs(jc, jcache, jmesh),
                t_shd.cache_specs(tc, tcache, tmesh))
    return j_shd.batch_specs(batch, jmesh), t_shd.batch_specs(batch, tmesh)


def _assert_same(j_tree, t_tree):
    js = j_flatten(jax.tree.map(lambda s: s, j_tree,
                                is_leaf=lambda x: isinstance(
                                    x, jax.sharding.PartitionSpec)))
    ts = t_flatten(t_tree)
    assert [p for p, _ in js] == [p for p, _ in ts]
    for (path, j), (_, t) in zip(js, ts):
        assert isinstance(t, t_shd.P), path
        assert tuple(j) == tuple(t), (path, j, t)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_jax_package(arch, mesh, kind):
    """Every leaf's spec, on the same mesh shape, under the JAX package's
    budget (the decisions must agree, not only the tables)."""
    _assert_same(*_specs(kind, arch, FakeMesh(MESHES[mesh]),
                         t_mesh.MeshShape(MESHES[mesh])))


def test_the_budgets_disagree_on_a_small_serving_mesh():
    """qwen3-14b (27.5 GiB of bf16 weights) served on 2x2: 13.75 GiB per
    rank is over half the v5e's 16 GiB (FSDP) and under half the H100's
    80 GiB (none).  Under each budget the port equals JAX's decision."""
    jc, jp, _, tc, tp, _, _ = _trees("qwen3-14b")
    shape = {"data": 2, "model": 2}
    jmesh, tmesh = FakeMesh(shape), t_mesh.MeshShape(shape)
    assert j_shd.decide_fsdp(jc, jp, jmesh, "serve")
    assert t_shd.decide_fsdp(tc, tp, tmesh, "serve",
                             hbm_bytes=j_shd.HBM_BYTES)
    assert not t_shd.decide_fsdp(tc, tp, tmesh, "serve")
    _assert_same(j_shd.param_specs(jc, jp, jmesh, kind="serve"),
                 t_shd.param_specs(tc, tp, tmesh, kind="serve",
                                   hbm_bytes=j_shd.HBM_BYTES))
    h100 = t_shd.param_specs(tc, tp, tmesh, kind="serve")
    _assert_same(j_shd.param_specs(jc, jp, jmesh, kind="serve", fsdp=False),
                 h100)
    assert "data" not in str(dict(t_flatten(h100)))


def test_mesh_helpers_read_shapes():
    for shape in MESHES.values():
        j, t = FakeMesh(shape), t_mesh.MeshShape(shape)
        assert t_mesh.data_axes(t) == j_shd.data_axes(j)
        assert t_mesh.model_axis_size(t) == 16
        assert t_mesh.num_chips(t) == int(np.prod(list(shape.values())))
        assert t_mesh.mesh_shape(j).shape == shape
    assert t_mesh.model_axis_size(t_mesh.MeshShape({"data": 4})) == 1
    # the dry-run's meshes are these shapes (make_production_mesh sets up
    # a fake process group: tests/test_torch_dryrun.py runs it in
    # processes of their own)
    assert {name: dict(zip(axes, shape)) for shape, axes, name in
            t_mesh.PRODUCTION_MESHES.values()} == MESHES


def test_the_roofline_constants_are_the_h100s():
    assert t_mesh.PEAK_FLOPS_BF16 == 989e12 and t_mesh.HBM_BW == 3.35e12
    assert t_shd.HBM_BYTES == 80 * 2 ** 30
    assert not hasattr(t_mesh, "ICI_BW")


def test_placements_follow_the_spec_major_to_minor():
    m = t_mesh.MeshShape({"pod": 2, "data": 2, "model": 2})
    P = t_shd.P
    assert t_shd.NamedSharding(m, P(("pod", "data"), None, "model")) \
        .placements == (Shard(0), Shard(0), Shard(2))
    assert t_shd.NamedSharding(m, P()).placements == (Replicate(),) * 3
    assert t_shd.NamedSharding(m, P(None, "data")).placements == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        t_shd.NamedSharding(m, P(("data", "pod"))).placements
    named = t_shd.to_named({"a": P("model"), "b": [P(), P("data")]}, m)
    assert [s.placements for _, s in t_flatten(named)] == [
        (Replicate(), Replicate(), Shard(0)), (Replicate(),) * 3,
        (Replicate(), Shard(0), Replicate())]


def test_spec_type_is_a_tree_leaf_like_partition_spec():
    P = t_shd.P
    assert P("a", ["b", "c"]) == P("a", ("b", "c"))
    assert tuple(P(None, ("b", "c"))) == tuple(
        jax.sharding.PartitionSpec(None, ("b", "c")))
    assert t_flatten({"x": P(), "y": P("data", None)}) == [
        ("x", P()), ("y", P("data", None))]
    assert len(P(None, "m")) == 2 and P(None, "m")[1] == "m"
    assert t_shd.fix_spec(P("model", None), (51_866, 1280),
                          t_mesh.MeshShape({"data": 16, "model": 16})) \
        == P(None, None)
