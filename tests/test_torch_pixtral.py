"""pixtral's decode past the dense cache, the way the JAX package does it.

The vlm's cache ``len`` counts its 4 patch embeddings, while the dense
backend gates joins and decode steps on its shared position, which
lags ``len`` by 4 (as the JAX backend's does), so the last decode steps
write at ``len >= max_len``.  ``jax.lax.dynamic_update_slice`` clamps
that write onto the last slot, and the attention then sees every slot
valid, with a window measured from the unclamped position; the port
clamps its in-place write the same way and gives the dense-decode
kernel ``lens = min(len + 1, S)`` with the window's end apart.  On the
CPU at smoke size in f32 with bridged weights (``dense_serving_checks.py``,
atol 1e-4; the attention alone 1e-5):

* ``TorchBackend`` token streams equal ``JaxBackend``'s, driven with
  joins to the end of ``max_len``, and the CLI serves 8/8;
* ``decode_step`` logits and caches past the cache's end (pixtral, and
  gemma2's window);
* the plain decode attention at and past the last slot, with and
  without a window, in the model and in the kernel's CPU wrapper;
* the norm ops' calls per model call and per train step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_serving_checks import (assert_caches_close, assert_close,
                                  counting_norm_ops, prompt_batch,
                                  run_both, setup, streams)
from repro.models import attention as ja
from repro.models import model as jm
from repro_torch.configs import TrainConfig, get_config
from repro_torch.kernels.decode_attention import ops as t_da_ops
from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as ta
from repro_torch.models import model as tm
from repro_torch.train import optim
from repro_torch.train.step import build_decode_step, build_train_step

torch.set_num_threads(1)
ARCH = "pixtral-12b"
PATCHES = 4
#: (prompt_len, max_new_tokens, arrival): the first request spans
#: max_len = 24 (10 + 14), so the shared position runs to its end; the
#: others join mid-stream
TO_THE_END = [(10, 14, 0.0), (6, 8, 1e-3), (8, 6, 2e-3), (5, 3, 4e-2),
              (9, 5, 5e-2), (4, 2, 6e-2)]


def test_token_streams_to_the_end_of_max_len_match_jax():
    max_len = 24
    (js, jreqs), (ts, treqs), tbe, joins, positions = run_both(
        ARCH, TO_THE_END, max_len, hbm_tokens=1e4)
    assert ts["completed"] == js["completed"] == len(TO_THE_END)
    assert sum(n_old > 0 for n_old, _ in joins) >= 2    # mid-stream joins
    # the first request's last step decodes at position max_len - 2; the
    # cache's len (position + 4) passed its last slot from position 20 on,
    # and those writes were clamped onto slot max_len - 1
    assert max(positions) == max_len - 2
    assert sum(p + PATCHES >= max_len for p in positions) >= PATCHES - 1
    assert streams(treqs) == streams(jreqs)
    for r in treqs:
        assert len(r.tokens) == r.max_new_tokens


def test_cli_serves_8_of_8_on_the_cpu():
    out = t_serve.main(["--arch", ARCH, "--smoke", "--backend", "dense",
                        "--device", "cpu", "--requests", "8"])
    assert out["summary"]["completed"] == 8
    for r in out["engine"].requests:
        assert len(r.tokens) == r.max_new_tokens


@pytest.mark.parametrize("arch", [ARCH, "gemma2-27b"])
def test_decode_steps_past_the_cache_match_jax(arch):
    """A cache of 12 slots holding 10 tokens (pixtral: 6 + its 4
    patches) and 5 decode steps: positions 10 to 14, the last three
    clamped onto slot 11; gemma2's local layers (window 8) measure the
    window from the unclamped position."""
    jcfg, tcfg, jp, tp = setup(arch)
    S = 10 - (PATCHES if jcfg.family == "vlm" else 0)
    max_len = 12
    jb, tb = prompt_batch(jcfg, 2, S)
    lj, jc = jm.prefill(jp, jcfg, jb, max_len)
    lt, tc = tm.prefill(tp, tcfg, tb, max_len)
    assert int(tc["len"]) == 10
    dec_j = jax.jit(lambda p, c, t: jm.decode_step(p, jcfg, c, t))
    dec_t = build_decode_step(tcfg)
    token = lt.argmax(-1)
    for _ in range(5):
        lj, jc = dec_j(jp, jc, jnp.asarray(token.numpy()))
        lt, tc = dec_t(tp, tc, token)
        assert_close(lt.numpy(), lj, "decode logits")
        assert_caches_close(tc, jc)
        token = lt.argmax(-1)
    assert int(tc["len"]) == 15


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("past", [0, 1, 4])
def test_plain_decode_attention_past_the_cache_matches_jax(past, window):
    """The query at position S - 1 + ``past`` of an S-slot cache: the
    model's ``decode_attention`` and the kernel's wrapper (its plain
    version on the CPU, which never launches the kernel) against the JAX
    package's plain path."""
    S, B, Hq, Hkv, D = 16, 2, 4, 2, 16
    r = np.random.default_rng(past * 10 + window)
    q = r.normal(0, 1, (B, 1, Hq, D)).astype(np.float32)
    kc = r.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)
    vc = r.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)
    pos = S - 1 + past
    kw = dict(window=window, attn_softcap=20.0, scale=0.3)
    j = np.asarray(ja.decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc)), jnp.asarray(pos, jnp.int32),
        use_pallas=False, **kw))
    args = [torch.from_numpy(a) for a in (q, kc, vc)]
    pos_t = torch.tensor(pos, dtype=torch.int32)
    before = decode_attention_fwd.launches
    for t in (ta.decode_attention(*args, pos_t, **kw),
              t_da_ops.decode_attention(*args, pos_t, **kw)):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=1e-5)
    assert decode_attention_fwd.launches == before


def norms_per_call(cfg) -> dict:
    """Norm ops per prefill or decode step: the first pre-norm
    (``rmsnorm``), every later pre-norm and the final norm
    (``add_rmsnorm``), each layer's RoPE (``qk_norm_rope``)."""
    L = cfg.num_layers
    return {"rmsnorm": 1, "add_rmsnorm": 2 * L, "qk_norm_rope": L,
            "gated_rmsnorm": 0}


def test_norm_ops_per_call_and_per_train_step(monkeypatch):
    """Counted on the CPU for a prefill, two decode steps (the second
    past the cache's end) and a train step under ``remat="full"`` (the
    forward, its final norm an ``rmsnorm``, and every layer again)."""
    assert norms_per_call(get_config(ARCH)) == {
        "rmsnorm": 1, "add_rmsnorm": 80, "qk_norm_rope": 40,
        "gated_rmsnorm": 0}
    _, cfg, _, p = setup(ARCH)
    calls = counting_norm_ops(monkeypatch)
    _, tb = prompt_batch(cfg, 2, 6)
    counts = []
    before = dict(calls)
    logits, cache = tm.prefill(p, cfg, tb, 11)
    counts.append({op: calls[op] - before[op] for op in calls})
    for _ in range(2):
        before = dict(calls)
        logits, cache = tm.decode_step(p, cfg, cache, logits.argmax(-1))
        counts.append({op: calls[op] - before[op] for op in calls})
    assert counts == [norms_per_call(cfg)] * 3
    L = cfg.num_layers
    before = dict(calls)
    tc = TrainConfig()
    toks = torch.randint(3, cfg.vocab_size, (2, 6))
    pe = torch.zeros((2, PATCHES, cfg.d_model))
    build_train_step(cfg, tc)(p, optim.init_opt_state(p, tc),
                              {"tokens": toks, "labels": torch.randint(3, cfg.vocab_size, (2, 10)),
                               "patch_embeds": pe})
    assert {op: calls[op] - before[op] for op in calls} == {
        "rmsnorm": 3, "add_rmsnorm": 2 * (2 * L - 1), "qk_norm_rope": 2 * L,
        "gated_rmsnorm": 0}
