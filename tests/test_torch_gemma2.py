"""gemma2's local/global layers in the port against the JAX package, on
the CPU at smoke size in f32 with bridged weights: (local, global)
layer pairs, the local layers' window (8 at smoke size: the prompts are
longer, so it binds in prefill and in decode), the post-norms, the
embedding scale, the attention scale of ``attn_scale_dim``, both
softcaps and the tied embedding.

* ``prefill`` + ``decode_step`` logits and every cache leaf
  (``local_k/v``, ``global_k/v``, ``len``) within 1e-4
  (``dense_serving_checks.py``);
* ``TorchBackend`` token streams equal ``JaxBackend``'s with joins and a
  preemption, and the CLI serves 8/8;
* ``forward_train`` + ``lm_loss``: the loss and every gradient leaf
  against ``jax.value_and_grad`` (``train_parity_checks.py``), with and
  without remat, and one AdamW step;
* the norm ops' calls per model call and per train step (on the card,
  each is one kernel launch; chip_smoke.py holds the launches to these
  counts at the published depth).

The paged path refuses gemma2, as the JAX package's does
(test_torch_model.py)."""
import jax
import pytest
import torch

from dense_serving_checks import (assert_caches_close, assert_close,
                                  counting_norm_ops, prompt_batch,
                                  run_both, setup, staggered, streams)
from repro.models import model as jm
from repro.train.step import build_loss_fn as j_build_loss_fn
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch import serve as t_serve
from repro_torch.models import model as tm
from repro_torch.train import optim
from repro_torch.train.step import (build_decode_step, build_loss_fn,
                                    build_prefill_step, build_train_step,
                                    value_and_grad)
from train_parity_checks import (LOSS_TOL, assert_trees_close, batch,
                                 configs, params, step_close, step_parity,
                                 to_jax, to_torch)

torch.set_num_threads(1)
ARCH = "gemma2-27b"


def test_smoke_config_keeps_what_the_slice_exercises():
    cfg = get_config(ARCH, smoke=True)
    assert cfg.local_global and cfg.num_layers % 2 == 0
    assert cfg.sliding_window == 8 and cfg.attn_scale_dim != 0
    assert cfg.attn_softcap > 0 and cfg.final_softcap > 0
    assert cfg.use_post_norm and cfg.embed_scale and cfg.tie_embeddings
    assert cfg.act == "gelu" and not cfg.use_qk_norm


@pytest.mark.parametrize("S", [5, 13])
def test_prefill_then_decode_match_jax(S):
    """A prompt inside the window (5) and past it (13): the logits of the
    prefill and of 4 decode steps, and every cache leaf after each."""
    jcfg, tcfg, jp, tp = setup(ARCH)
    max_len = S + 6
    jb, tb = prompt_batch(jcfg, 2, S)
    lj, jc = jax.jit(lambda p, b: jm.prefill(p, jcfg, b, max_len))(jp, jb)
    lt, tc = build_prefill_step(tcfg, max_len)(tp, tb)
    assert_close(lt.numpy(), lj, "prefill logits")
    assert_caches_close(tc, jc)
    assert tc["local_k"].shape == (tcfg.num_layers // 2, 2, max_len,
                                   tcfg.num_kv_heads, tcfg.head_dim)
    dec_j = jax.jit(lambda p, c, t: jm.decode_step(p, jcfg, c, t))
    dec_t = build_decode_step(tcfg)
    token = lt.argmax(-1)
    for _ in range(4):
        lj, jc = dec_j(jp, jc, jax.numpy.asarray(token.numpy()))
        lt, tc = dec_t(tp, tc, token)
        assert_close(lt.numpy(), lj, "decode logits")
        assert_caches_close(tc, jc)
        token = lt.argmax(-1)


def test_token_streams_match_jax_with_joins_and_preemption():
    (js, jreqs), (ts, treqs), tbe, joins, _ = run_both(ARCH, staggered(),
                                                       32)
    assert ts["completed"] == js["completed"] == 8
    assert ts["preemptions"] == js["preemptions"] > 0
    assert sum(n_old > 0 for n_old, _ in joins) >= 2    # mid-stream joins
    assert streams(treqs) == streams(jreqs)
    assert tbe.empty and tbe._cache is None


def test_cli_serves_on_the_cpu():
    out = t_serve.main(["--arch", ARCH, "--smoke", "--backend", "dense",
                        "--device", "cpu", "--requests", "8"])
    assert out["summary"]["completed"] == 8
    for r in out["engine"].requests:
        assert len(r.tokens) == r.max_new_tokens


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_every_grad_leaf_match_jax(remat):
    jcfg, tcfg = configs(ARCH, remat=remat)
    jp, tp = params(jcfg)
    b = batch(jcfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(j_build_loss_fn(jcfg),
                                                has_aux=True))(jp, to_jax(b))
    (tl, tmet), tg = value_and_grad(build_loss_fn(tcfg), tp, to_torch(b))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    for key in ("ce_loss", "tokens", "total_loss"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= LOSS_TOL, key
    assert_trees_close(tg, jg)


def test_train_step_matches_jax():
    j, t, (_, tc, _, _) = step_parity(ARCH)
    step_close(t, j, tc)


def norms_per_call(cfg) -> dict:
    """Norm ops per prefill or decode step: the first pre-norm
    (``rmsnorm``), every later pre-norm and the final norm
    (``add_rmsnorm``, adding the previous block's output), each layer's
    RoPE (``qk_norm_rope``: gemma2 has no qk-norm) and the two post-norms
    of each layer (``rmsnorm``)."""
    L = cfg.num_layers
    return {"rmsnorm": 1 + 2 * L, "add_rmsnorm": 2 * L, "qk_norm_rope": L,
            "gated_rmsnorm": 0}


def norms_per_train_step(cfg) -> dict:
    """Norm ops in one train step under ``remat="full"``: the forward
    (the final norm ``rmsnorm``, as the train mode sums the hidden
    first), then the backward's recompute of every pair (all but the
    final norm)."""
    fwd = norms_per_call(cfg)
    fwd["rmsnorm"] += 1
    fwd["add_rmsnorm"] -= 1
    return {op: 2 * n - (op == "rmsnorm") if n else 0
            for op, n in fwd.items()}


def test_norm_ops_per_call_and_per_train_step(monkeypatch):
    """Counted on the CPU for a prefill, two decode steps and a train
    step; at the published depth the counts are the launches
    chip_smoke.py holds the card to."""
    assert norms_per_call(get_config(ARCH)) == {
        "rmsnorm": 93, "add_rmsnorm": 92, "qk_norm_rope": 46,
        "gated_rmsnorm": 0}
    assert norms_per_train_step(get_config(ARCH).replace(num_layers=2)) == {
        "rmsnorm": 11, "add_rmsnorm": 6, "qk_norm_rope": 4,
        "gated_rmsnorm": 0}
    _, cfg, _, p = setup(ARCH)
    calls = counting_norm_ops(monkeypatch)
    _, tb = prompt_batch(cfg, 2, 11)
    counts = []
    before = dict(calls)
    logits, cache = tm.prefill(p, cfg, tb, 16)
    counts.append({op: calls[op] - before[op] for op in calls})
    for _ in range(2):
        before = dict(calls)
        logits, cache = tm.decode_step(p, cfg, cache, logits.argmax(-1))
        counts.append({op: calls[op] - before[op] for op in calls})
    assert counts == [norms_per_call(cfg)] * 3
    before = dict(calls)
    tc = TrainConfig()
    toks = torch.randint(3, cfg.vocab_size, (2, 8))
    build_train_step(cfg, tc)(p, optim.init_opt_state(p, tc),
                              {"tokens": toks, "labels": toks})
    assert {op: calls[op] - before[op] for op in calls} == \
        norms_per_train_step(cfg)
