"""The port's step analyzer (``repro_torch.utils.step_analyzer``) on op
sequences whose FLOPs, bytes, temporaries and loops are counted by hand
here; the functions the feature probe calls against the JAX package's:
``input_specs`` shapes and dtypes for every arch and every ``SHAPES``
cell (the twin of ``tests/test_sharding.py``'s), ``concrete_inputs``'
values for every arch and step kind, and ``build_serve_step``'s next
tokens and cache over four steps on qwen3-0.6b smoke with bridged f32
weights (tokens equal, cache within 1e-4, ``test_torch_model.py``'s
bound); and the collective counter on 4 gloo ranks: ``moe_ffn_ep``'s
forward at the MoE smoke issues two all-to-alls, each of the rank's
``[E, C, d]`` dispatch buffer."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import concrete_inputs as j_concrete
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_specs
from repro.models import model as jm
from repro.train.step import build_serve_step as j_serve_step
from repro_torch.configs import ARCH_IDS, SHAPES, all_cells
from repro_torch.configs import concrete_inputs as t_concrete
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import input_specs as t_specs
from repro_torch.configs import smoke_shape
from repro_torch.models.params import from_jax
from repro_torch.train.step import build_serve_step as t_serve_step
from repro_torch.utils.step_analyzer import analyze, note_loop

sys.path.insert(0, os.path.dirname(__file__))
import scaleout_ranks  # noqa: E402

torch.set_num_threads(1)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# --- the analyzer on hand-counted op sequences -------------------------------

def test_matmul_then_tanh():
    """mm [8,16] @ [16,32]: 2·8·16·32 FLOPs, reads 512 + 2048 B and
    writes 1024; tanh reads and writes 1024.  The product lives while
    tanh writes the output, which is returned (not a temporary)."""
    c = analyze(lambda x, w: torch.tanh(x @ w), _meta(8, 16), _meta(16, 32))
    assert c.flops == 2 * 8 * 16 * 32
    assert c.hbm_bytes == (512 + 2048 + 1024) + (1024 + 1024)
    assert (c.argument_bytes, c.output_bytes, c.output_leaves) == \
        (512 + 2048, 1024, 1)
    assert c.peak_temp_bytes == 1024
    assert (c.matmul_count, c.op_count) == (1, 2)
    assert c.loops == [] and c.collective_counts == {}


def test_views_move_nothing():
    """view, transpose and slice are aliases: only the sum reads its
    7 x 4 f32 elements and writes one."""
    c = analyze(lambda x: x.view(4, 8).t()[1:].sum(), _meta(32))
    assert c.hbm_bytes == 7 * 4 * 4 + 4
    assert c.op_count == 1 and c.flops == 0


def test_in_place_writes():
    """``index_copy_`` writes its source's 2 rows into the argument's
    slots: the source and the indices read, the source's bytes written
    (XLA's dynamic-update-slice); ``add_`` reads y and writes x once."""
    def f(cache, src, idx, x, y):
        cache.index_copy_(0, idx, src)
        x.add_(y)
        return cache, x
    c = analyze(f, _meta(10, 4), _meta(2, 4),
                _meta(2, dtype=torch.int64), _meta(6), _meta(6))
    assert c.hbm_bytes == (32 + 16 + 32) + (24 + 24)
    assert c.peak_temp_bytes == 0      # both write the arguments in place
    assert c.output_bytes == 160 + 24


def test_peak_follows_lifetimes():
    """a and b live together (2 KiB), then b and c; the sum is the
    output.  Freed storages stop counting at once."""
    def f(x):
        a = x * 2
        b = a * 3
        del a
        c = b + 1
        del b
        return c.sum()
    c = analyze(f, _meta(256))
    assert c.peak_temp_bytes == 2 * 1024
    assert c.hbm_bytes == 3 * 2048 + 1028


def test_saved_tensors_stay_live_until_the_backward():
    """tanh's output is saved for its backward: it lives past the
    forward although no Python name holds it, so the peak holds the
    product, the saved output and the gradients' buffers at once."""
    def f(w, x):
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            y = torch.tanh(x @ w)
            return torch.autograd.grad(y.sum(), w)[0]
    n = 64 * 64 * 4
    c = analyze(f, _meta(64, 64), _meta(64, 64))
    assert c.peak_temp_bytes >= 2 * n
    assert c.flops == 3 * 2 * 64 ** 3 - 2 * 64 ** 3  # fwd mm, grad_w mm


def test_layer_stacks_and_declared_loops():
    """A walk of a stacked [5, ...] tree is one loop of trip 5; a loop
    declared inside it counts once per walk, not once per layer; the
    backward walks both again."""
    def fwd(stack, x):
        for w in torch.unbind(stack):
            note_loop("inner", 3)
            x = torch.tanh(x @ w)
        return x
    c = analyze(fwd, _meta(5, 8, 8), _meta(2, 8))
    assert [(lp["name"], lp["trip"]) for lp in c.loops] == \
        [("layers", 5), ("inner", 3)]
    assert c.flops == 5 * 2 * 2 * 8 * 8

    def train(stack, x):
        stack = stack.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(fwd(stack, x).sum(), stack)[0]
    c = analyze(train, _meta(5, 8, 8), _meta(2, 8))
    assert [(lp["name"], lp["trip"], lp["phase"]) for lp in c.loops] == [
        ("layers", 5, "forward"), ("inner", 3, "forward"),
        ("layers", 5, "backward"), ("inner", 3, "backward")]
    # forward 5 products; backward 5 weight gradients and 4 input
    # gradients (the first layer's input needs none)
    assert c.flops == (5 + 5 + 4) * 2 * 2 * 8 * 8


def test_real_arguments_are_not_touched():
    """Real tensors become fake ones of their shape: the step computes
    nothing on them and writes nothing to them."""
    x = torch.ones(4, 4)
    c = analyze(lambda t: t.mul_(3).sum(), x)
    assert torch.equal(x, torch.ones(4, 4))
    assert c.argument_bytes == 64 and c.op_count == 2


# --- input_specs, concrete_inputs, build_serve_step --------------------------

def _flat(tree, dtype_name, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], dtype_name, f"{path}/{k}"))
        return out
    return {path: (tuple(tree.shape), dtype_name(tree.dtype))}


def _jax_dtype(d):
    return jnp.dtype(d).name


def _torch_dtype(d):
    return str(d).removeprefix("torch.")


def test_input_specs_cover_all_cells_as_jax():
    cells = all_cells()
    assert len(cells) == 32  # 10 archs x 3 + 2 long_500k
    for arch, shape in cells:
        cfg = t_get_config(arch)
        got = t_specs(cfg, SHAPES[shape])
        want = j_specs(j_get_config(arch), SHAPES[shape])
        assert _flat(got, _torch_dtype) == _flat(want, _jax_dtype), \
            (arch, shape)
        leaves = jax.tree.leaves(got)
        assert all(t.device.type == "meta" for t in leaves), (arch, shape)


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _torch_np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_concrete_inputs_equal_jax(arch, kind):
    shape = smoke_shape(kind)
    got = t_concrete(t_get_config(arch, smoke=True), shape)
    want = j_concrete(j_get_config(arch, smoke=True), shape)
    assert _flat(got, _torch_dtype) == _flat(want, _jax_dtype)
    for (p, g), (_, w) in zip(
            sorted(jax.tree_util.tree_flatten_with_path(got)[0],
                   key=lambda kv: jax.tree_util.keystr(kv[0])),
            sorted(jax.tree_util.tree_flatten_with_path(want)[0],
                   key=lambda kv: jax.tree_util.keystr(kv[0]))):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(_torch_np(g), _np(w), err_msg=str(p))


def test_serve_step_equals_jax():
    """Four greedy serve steps from concrete_inputs' token and zero
    cache, each step's token fed to the next: the tokens equal, every
    cache leaf within 1e-4."""
    jcfg = j_get_config("qwen3-0.6b", smoke=True).replace(**F32)
    tcfg = t_get_config("qwen3-0.6b", smoke=True).replace(**F32)
    jp = jm.init(jcfg, jax.random.key(0))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    shape = smoke_shape("decode")
    jin, tin = j_concrete(jcfg, shape), t_concrete(tcfg, shape)
    jstep, tstep = jax.jit(j_serve_step(jcfg)), t_serve_step(tcfg)
    jtok, jcache = jin["token"], jin["cache"]
    ttok, tcache = tin["token"], tin["cache"]
    for _ in range(4):
        jtok, jcache = jstep(jp, jtok, jcache)
        ttok, tcache = tstep(tp, ttok, tcache)
        assert ttok.dtype == torch.int32 and ttok.shape == (2, 1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        assert set(tcache) == set(jcache)
        for k in jcache:
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), atol=1e-4,
                                       rtol=0, err_msg=k)


# --- collectives on 4 gloo ranks ---------------------------------------------

def test_moe_ep_forward_counts_two_all_to_alls(tmp_path):
    """Each rank's ``moe_ffn_ep`` forward: the exchange and its reverse
    (two all-to-alls, each of the rank's [E, C, d] buffer), and the
    partial sum over 'model' of the f-split expert GEMMs (one
    all-reduce); nothing moves under the fake mode."""
    ranks = scaleout_ranks.spawn("analyze_moe_ep_rank", tmp_path,
                                 "qwen3-moe-30b-a3b")
    for r in ranks:
        assert r["counts"] == {"all-to-all": 2, "all-reduce": 1}
        assert r["bytes"]["all-to-all"] == 2 * r["buffer"]
