"""SSM (mamba2) and hybrid (zamba2) serving in the port against the JAX
package, on the CPU in f32 with bridged weights.

* The Mamba2 pieces (``causal_conv1d``, ``conv_step``,
  ``ssd_decode_step``, ``mamba2_block`` in prefill and decode) against
  ``repro.models.ssm`` at atol 1e-4 (f32 sums in a different order).
* ``prefill`` + ``decode_step`` logits and caches against
  ``repro.models.model`` on mamba2-780m and zamba2-2.7b smoke, with a
  prompt of three smoke chunks (S = 40, chunk 16), at atol 1e-4.
* The bridge carries the hybrid's unstacked ``shared`` subtree and the
  f32 ``dt_bias`` / ``A_log`` / ``D`` leaves of a bf16 model bit for bit.

Serving through the engine is in test_torch_ssm_serving.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.models import ssm as js
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import ssm as ts
from repro_torch.models.params import from_jax
from repro_torch.train.step import build_decode_step, build_prefill_step

torch.set_num_threads(1)
ATOL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = ["mamba2-780m", "zamba2-2.7b"]


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


def _setup(arch, seed=0):
    jcfg = j_get_config(arch, smoke=True).replace(**F32)
    tcfg = t_get_config(arch, smoke=True).replace(**F32)
    jp = jm.init(jcfg, jax.random.key(seed))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def test_causal_conv1d_and_conv_step_match_jax():
    r = np.random.default_rng(0)
    x = r.normal(0, 1, (2, 9, 12)).astype(np.float32)
    w = r.normal(0, 0.3, (4, 12)).astype(np.float32)
    b = r.normal(0, 0.1, (12,)).astype(np.float32)
    _close(ts.causal_conv1d(*(torch.from_numpy(a) for a in (x, w, b))),
           js.causal_conv1d(*(jnp.asarray(a) for a in (x, w, b))))
    cache = r.normal(0, 1, (2, 3, 12)).astype(np.float32)
    tc, ty = ts.conv_step(*(torch.from_numpy(a) for a in (cache, x[:, 0],
                                                          w, b)))
    jc, jy = js.conv_step(*(jnp.asarray(a) for a in (cache, x[:, 0], w, b)))
    _close(tc, jc)
    _close(ty, jy)


def test_ssd_decode_step_matches_jax():
    r = np.random.default_rng(1)
    B, H, P, N, G = 2, 4, 8, 16, 2
    args = [r.normal(0, 0.5, (B, H, P, N)), r.normal(0, 1, (B, H, P)),
            np.abs(r.normal(0, 1, (B, H))), -np.abs(r.normal(0, 1, (H,))),
            r.normal(0, 1, (B, G, N)), r.normal(0, 1, (B, G, N))]
    args = [a.astype(np.float32) for a in args]
    t_state, t_y = ts.ssd_decode_step(*(torch.from_numpy(a) for a in args))
    j_state, j_y = jax.jit(js.ssd_decode_step)(*(jnp.asarray(a)
                                                 for a in args))
    _close(t_state, j_state)
    _close(t_y, j_y)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_block_prefill_and_decode_match_jax(arch):
    """One Mamba2 block: a stateless prefill, a prefill from a non-zero
    state (y, the final SSM state and the raw conv tail) and a decode
    step from that state."""
    jcfg, tcfg, jp, tp = _setup(arch)
    jpb = jax.tree.map(lambda a: a[0], jp["blocks"]["mamba"])
    tpb = {k: v[0] for k, v in tp["blocks"]["mamba"].items()}
    r = np.random.default_rng(2)
    B, S = 2, 21
    x = r.normal(0, 1, (B, S, jcfg.d_model)).astype(np.float32)
    dm = ts.mamba2_dims(tcfg)
    ssm0 = r.normal(0, 0.5, (B, dm["H"], dm["P"], dm["N"]))
    ssm0 = ssm0.astype(np.float32)
    conv0 = r.normal(0, 1, (B, tcfg.conv_width - 1,
                            dm["conv_ch"])).astype(np.float32)
    j_block = jax.jit(lambda p, x, st: js.mamba2_block(p, jcfg, x, st))
    j_step = jax.jit(lambda p, x, st: js.mamba2_block(p, jcfg, x, st,
                                                      decode=True))
    ty, tst = ts.mamba2_block(tpb, tcfg, torch.from_numpy(x))
    jy, jst = j_block(jpb, jnp.asarray(x), None)
    assert tst is None and jst is None
    _close(ty, jy)
    tstate = ts.SSMState(torch.from_numpy(ssm0), torch.from_numpy(conv0))
    jstate = js.SSMState(jnp.asarray(ssm0), jnp.asarray(conv0))
    ty, tst = ts.mamba2_block(tpb, tcfg, torch.from_numpy(x), tstate)
    jy, jst = j_block(jpb, jnp.asarray(x), jstate)
    _close(ty, jy)
    _close(tst.ssm, jst.ssm)
    _close(tst.conv, jst.conv)
    ty, tst = ts.mamba2_block(tpb, tcfg, torch.from_numpy(x[:, :1]), tst,
                              decode=True)
    jy, jst = j_step(jpb, jnp.asarray(x[:, :1]), jst)
    _close(ty, jy)
    _close(tst.ssm, jst.ssm)
    _close(tst.conv, jst.conv)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch):
    """A 40-token prompt is three chunks of the smoke configs' 16 (the
    last ragged): the inter-chunk carry runs.  Logits and every cache
    array (SSM and conv states, the hybrid's per-application KV) agree
    after the prefill and after each decode step; the decode steps update
    the port's cache in place."""
    jcfg, tcfg, jp, tp = _setup(arch)
    assert tcfg.ssm_chunk == 16
    r = np.random.default_rng(3)
    B, S, max_len = 2, 40, 48
    toks = r.integers(3, jcfg.vocab_size, (B, S)).astype(np.int32)
    lj, jc = jax.jit(lambda p, b: jm.prefill(p, jcfg, b, max_len))(
        jp, {"tokens": jnp.asarray(toks)})
    lt, tc = build_prefill_step(tcfg, max_len)(
        tp, {"tokens": torch.from_numpy(toks).long()})
    _close(lt, lj)
    assert sorted(tc) == sorted(jc)

    def caches_match():
        assert int(tc["len"]) == int(jc["len"])
        for key in jc:
            if key != "len":
                assert tuple(tc[key].shape) == jc[key].shape, key
                _close(tc[key], jc[key])

    caches_match()
    dec_j = jax.jit(lambda p, c, t: jm.decode_step(p, jcfg, c, t))
    dec_t = build_decode_step(tcfg)
    token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)    # [B, 1]
    for _ in range(3):
        ssm_before = tc["ssm"]
        lj, jc = dec_j(jp, jc, jnp.asarray(token))
        lt, tc = dec_t(tp, tc, torch.from_numpy(token).long())
        assert tc["ssm"] is ssm_before                         # in place
        _close(lt, lj)
        caches_match()
        token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)


def test_bridge_carries_hybrid_shared_and_f32_ssm_leaves_exactly():
    """A bf16 zamba2: the unstacked ``shared`` attention + MLP subtree
    and the f32 ``dt_bias`` / ``A_log`` / ``D`` leaves cross bit for
    bit, each in its own dtype."""
    cfg = j_get_config("zamba2-2.7b", smoke=True)
    jp = jm.init(cfg, jax.random.key(4))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    assert sorted(tp["shared"]) == ["attn", "mlp"]
    for sub in ("attn", "mlp"):
        for name, j in jp["shared"][sub].items():
            t, j = tp["shared"][sub][name], np.asarray(j)
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          j.view(np.int16), err_msg=name)
    for name in ("dt_bias", "A_log", "D"):
        t = tp["blocks"]["mamba"][name]
        j = np.asarray(jp["blocks"]["mamba"][name])
        assert t.dtype == torch.float32 and j.dtype == np.float32
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_ssm_state_matches_jax(arch):
    """Zero SSM and conv states of the JAX package's shapes and dtypes
    (the SSM state fp32 whatever the model's dtype)."""
    cfg_j, cfg_t = j_get_config(arch, smoke=True), t_get_config(arch,
                                                               smoke=True)
    j = js.init_ssm_state(cfg_j, 3, jnp.bfloat16)
    t = ts.init_ssm_state(cfg_t, 3, torch.bfloat16, device="cpu")
    for tt, jj in zip(t, j):
        assert tuple(tt.shape) == jj.shape and not tt.any()
        assert str(tt.dtype).split(".")[-1] == str(jj.dtype)
    assert t.ssm.dtype == torch.float32 and t.conv.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [2, 16])
def test_prefill_then_decode_equals_a_longer_prefill(arch, S):
    """Prefilling S tokens and decoding token S+1 gives the logits of a
    prefill of all S+1: the SSM and conv states carry exactly, across a
    chunk edge (S = 16, the smoke chunk) and for a prompt shorter than
    the conv window (S = 2 < W - 1 = 3, whose conv state keeps the
    fresh cache's zeros in its first slot)."""
    _, tcfg, _, tp = _setup(arch)
    r = np.random.default_rng(5)
    toks = torch.from_numpy(r.integers(3, tcfg.vocab_size, (2, S + 1))).long()
    _, cache = build_prefill_step(tcfg, S + 4)(tp, {"tokens": toks[:, :S]})
    got, _ = build_decode_step(tcfg)(tp, cache, toks[:, S:])
    want, _ = build_prefill_step(tcfg, S + 4)(tp, {"tokens": toks})
    _close(got, want.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_scan_reads_no_initial_state(arch, monkeypatch):
    """A prefill starts from the fresh cache's zero state, so each layer's
    scan gets no initial state (the kernel reads no zeros); the state it
    returns lands in the cache."""
    from repro_torch.kernels.ssd_scan import ops as t_ssd_ops
    _, tcfg, _, tp = _setup(arch)
    scan, given = t_ssd_ops.ssd_scan, []

    def recorded(*args, initial_state=None, **kw):
        given.append(initial_state)
        return scan(*args, initial_state=initial_state, **kw)

    monkeypatch.setattr(t_ssd_ops, "ssd_scan", recorded)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        3, tcfg.vocab_size, (2, 20))).long()
    _, cache = build_prefill_step(tcfg, 24)(tp, {"tokens": toks})
    assert len(given) == tcfg.num_layers
    assert all(s is None for s in given)
    assert cache["ssm"].abs().amax(dim=(1, 2, 3, 4)).min() > 0
