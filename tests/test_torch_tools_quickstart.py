"""``repro_torch.tools.quickstart`` on the CPU against the JAX package's
``examples/quickstart.py``: the same ~100M config; at a narrow cut of it
(2 layers, d 64, f32) 4 steps equal 2 steps plus a ``--resume`` of 2 bit
for bit (losses, parameters, moments, count), and with the JAX
quickstart's initial parameters carried across (``from_jax``) the first 2
losses lie within 1e-5 of JAX's ``build_train_step``'s."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as j_make_batch
from repro.models import model as jm
from repro.train import optim as j_optim
from repro.train.step import build_train_step as j_build_train_step
from repro_torch.models.params import from_jax
from repro_torch.tools import quickstart
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=512)
B, S = 2, 32


def _jax_quickstart():
    spec = importlib.util.spec_from_file_location(
        "jax_quickstart", os.path.join(ROOT, "examples", "quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(tmp, steps, *extra):
    return quickstart.parser().parse_args(
        ["--steps", str(steps), "--batch", str(B), "--seq", str(S),
         "--ckpt-every", "2", "--ckpt-dir", str(tmp), "--device", "cpu",
         *extra])


def _state(out):
    return tree_leaves({"params": out["params"], "m": out["opt"].m,
                        "v": out["opt"].v, "count": out["opt"].count})


def test_config_is_the_jax_quickstarts():
    assert dataclasses.asdict(quickstart.quickstart_config()) == \
        dataclasses.asdict(_jax_quickstart().quickstart_config())


def test_resume_is_bit_for_bit(tmp_path):
    cfg = quickstart.quickstart_config().replace(**NARROW)
    whole = quickstart.train(_args(tmp_path / "a", 4), cfg)
    first = quickstart.train(_args(tmp_path / "b", 2), cfg)
    rest = quickstart.train(_args(tmp_path / "b", 4, "--resume"), cfg)
    assert rest["start"] == 2 and len(rest["losses"]) == 2
    assert first["losses"] + rest["losses"] == whole["losses"]
    assert whole["losses"][-1] < whole["losses"][0]
    for a, b in zip(_state(whole), _state(rest), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_first_losses_match_jax(tmp_path):
    jcfg = _jax_quickstart().quickstart_config().replace(**NARROW)
    tc = JTrainConfig(learning_rate=1e-3, warmup_steps=20, total_steps=2,
                      checkpoint_every=2, checkpoint_dir=str(tmp_path))
    jp = jm.init(jcfg, jax.random.key(0))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    opt = j_optim.init_opt_state(jp, tc)
    step_fn = jax.jit(j_build_train_step(jcfg, tc))
    shape = JShapeConfig("quickstart", "train", S, B)
    want = []
    for i in range(2):
        batch = {k: jnp.asarray(v) for k, v in j_make_batch(
            jcfg, shape, JDataConfig(kind="lm_synthetic"), i).items()}
        jp, opt, metrics = step_fn(jp, opt, batch)
        want.append(float(metrics["total_loss"]))
    cfg = quickstart.quickstart_config().replace(**NARROW)
    got = quickstart.train(_args(tmp_path / "t", 2), cfg, params=tp)
    np.testing.assert_allclose(got["losses"], want, rtol=0, atol=1e-5)
    assert got["losses"][0] == pytest.approx(np.log(512), abs=0.5)
