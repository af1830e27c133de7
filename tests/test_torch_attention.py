"""The port's ``attention`` against the JAX package's (f32, CPU, atol
2e-5: both sides accumulate in f32, in a different order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ja
from repro_torch.models import attention as ta

torch.set_num_threads(1)
ATOL = 2e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


def _qkv(B, Q, K, Hq, Hkv, D, seed):
    r = np.random.default_rng(seed)
    return (r.normal(0, 1, (B, Q, Hq, D)).astype(np.float32),
            r.normal(0, 1, (B, K, Hkv, D)).astype(np.float32),
            r.normal(0, 1, (B, K, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=5),
    dict(causal=True, attn_softcap=20.0),
    dict(causal=True, kv_len="vec"),
    dict(causal=True, q_positions="2d", kv_len="vec"),
    dict(causal=True, f32_logits=False),
    dict(causal=True, window=4, attn_softcap=30.0, f32_logits=False),
], ids=["causal", "noncausal", "window", "softcap", "kv_len", "qpos2d",
        "bf16path-f32in", "window-softcap-nof32"])
def test_attention(kw):
    B, Q, K, Hq, Hkv, D = 2, 6, 6, 4, 2, 16
    if kw.get("q_positions") == "2d":
        Q = 1
    q, k, v = _qkv(B, Q, K, Hq, Hkv, D, seed=11)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("kv_len") == "vec":
        kv = np.asarray([3, 6], np.int32)
        jkw["kv_len"], tkw["kv_len"] = jnp.asarray(kv), torch.from_numpy(kv)
    if kw.get("q_positions") == "2d":
        qp = np.asarray([[2], [5]], np.int32)
        jkw["q_positions"] = jnp.asarray(qp)
        tkw["q_positions"] = torch.from_numpy(qp)
    out_t = ta.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         scale=0.3, **tkw)
    out_j = ja.attention(*(jnp.asarray(a) for a in (q, k, v)),
                         scale=0.3, **jkw)
    _close(out_t, out_j)


def test_attention_bf16_logits_branch():
    """bf16 inputs with f32_logits=False take the -3e4 mask and bf16
    softmax branch on both sides; bf16 rounding sites differ, so the
    tolerance is the repo's bf16 one."""
    q, k, v = _qkv(1, 4, 4, 2, 1, 16, seed=3)
    kw = dict(causal=True, f32_logits=False, window=2)
    out_t = ta.attention(*(torch.from_numpy(a).bfloat16()
                           for a in (q, k, v)), **kw)
    out_j = ja.attention(*(jnp.asarray(a, jnp.bfloat16)
                           for a in (q, k, v)), **kw)
    _close(out_t, out_j, atol=2e-2)


def test_flash_branch_and_dense_decode_on_cpu():
    """The flash branch of ``attention`` (Q == K > 1, causal, no kv_len)
    and ``decode_attention`` compute on the CPU (the plain path, as the
    JAX package's XLA path does), and whisper's encdec decode step, which
    the dense path once refused, runs its decoder through them."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm
    q, k, v = _qkv(1, 4, 4, 2, 1, 8, seed=5)
    out_t = ta.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         use_pallas=True)
    out_j = ja.attention(*(jnp.asarray(a) for a in (q, k, v)))
    _close(out_t, out_j)
    dec_t = ta.decode_attention(torch.from_numpy(q[:, :1]),
                                torch.from_numpy(k), torch.from_numpy(v), 2)
    dec_j = ja.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                jnp.asarray(v), 2)
    _close(dec_t, dec_j)
    cfg = get_config("whisper-large-v3", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    p = tm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.full((1, 4), 7),
             "enc_embeds": torch.zeros((1, 8, cfg.d_model))}
    logits, cache = tm.prefill(p, cfg, batch, 8)
    logits, cache = tm.decode_step(p, cfg, cache, logits.argmax(-1))
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all() and int(cache["len"]) == 5
