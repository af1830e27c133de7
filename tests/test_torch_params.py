"""Parameters and footprints: the JAX -> PyTorch weight bridge is exact,
the port's abstract trees have the JAX package's byte counts for every
architecture (so the footprint estimator fits the same curve), and native
init follows the spec tree."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.sched import estimator as j_est
from repro.utils.tree import tree_bytes as j_tree_bytes
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as tm
from repro_torch.models.params import from_jax
from repro_torch.sched import estimator as t_est
from repro_torch.utils.tree import tree_bytes as t_tree_bytes

torch.set_num_threads(1)


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bridge_is_exact(dtype):
    cfg = j_get_config("qwen3-0.6b", smoke=True).replace(
        param_dtype=dtype, compute_dtype=dtype)
    jp = jm.init(cfg, jax.random.key(0))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    jleaves, tleaves = dict(_flat(jp)), dict(_flat(tp))
    assert jleaves.keys() == tleaves.keys()
    for name, j in jleaves.items():
        t, j = tleaves[name], np.asarray(j)
        assert tuple(t.shape) == j.shape, name
        if dtype == "bfloat16":
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), j.view(np.int16), err_msg=name)
        else:
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_bytes_match_jax(arch):
    """Full configs, abstract only: meta tensors allocate nothing."""
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    assert t_tree_bytes(tm.abstract(tcfg)) == \
        j_tree_bytes(jm.abstract(jcfg))
    for batch, max_len in ((2, 161), (4, 4096)):
        assert t_tree_bytes(tm.init_cache(tcfg, batch, max_len,
                                          abstract_only=True)) == \
            j_tree_bytes(jm.init_cache(jcfg, batch, max_len,
                                       abstract_only=True))
    assert tm.abstract(tcfg)["embed"].is_meta


def test_footprint_calibration_matches_jax():
    j = j_est.calibrate_model_footprint(j_get_config("qwen3-0.6b"), 161,
                                        refit=True)
    t = t_est.calibrate_model_footprint(t_get_config("qwen3-0.6b"), 161,
                                        refit=True)
    assert (t.family, t.m, t.b) == (j.family, j.m, j.b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_native_init_follows_specs(arch):
    """Smoke configs: every leaf has the abstract shape and dtype; the
    ``ones``/``zeros`` rules are exact and the random rules draw from the
    generator (the same seed gives the same tree)."""
    cfg = t_get_config(arch, smoke=True)
    abst = dict(_flat(tm.abstract(cfg)))
    a = dict(_flat(tm.init(cfg, torch.Generator().manual_seed(0), "cpu")))
    b = dict(_flat(tm.init(cfg, torch.Generator().manual_seed(0), "cpu")))
    assert a.keys() == abst.keys()
    for name, x in a.items():
        assert x.shape == abst[name].shape and x.dtype == abst[name].dtype
        assert torch.equal(x, b[name]), name
    assert torch.all(a["final_ln_w"] == 1)


def test_native_init_scales():
    cfg = t_get_config("qwen3-0.6b", smoke=True).replace(
        param_dtype="float32")
    p = tm.init(cfg, torch.Generator().manual_seed(1), "cpu")
    emb_std = p["embed"].std().item()
    wq_std = p["blocks"]["attn"]["wq"].std().item()
    assert abs(emb_std - 0.02) < 0.002                # "embed", scale 0.02
    assert abs(wq_std - cfg.d_model ** -0.5) < 0.01   # fan_in over d_model
