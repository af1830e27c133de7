"""The port's MoE layer and MoE model steps against the JAX package, on
the CPU with numpy inputs from a seed (and bridged weights).

* ``router_topk``, ``load_balance_loss`` and ``moe_ffn`` against
  ``repro.models.moe`` in f32 at atol 1e-5 (the same products; the
  combine sums each token's k slots in another order), with random
  routing, with a router that forces experts past their capacity C
  (which pins the JAX result: in an overflowing expert, the kept token in
  slot C-1 gets a zero expert output), and over a range of token counts
  (the drops follow C, so they pin its formula).
* ``moe_ffn`` in bf16 against JAX in bf16 at atol/rtol 3e-2: outputs of
  order 1, where one bf16 ulp is 2**-7, rounded at other places (the
  products, the activation, the gate times up) by the two frameworks.
* ``moe_block`` (with and without the shared expert) and the qwen3-moe
  smoke model's ``prefill`` / ``decode_step`` and ``prefill_chunk`` /
  ``decode_step_paged`` logits and caches at atol 1e-4, as in
  test_torch_model.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.models import moe as jmoe
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models.params import from_jax
from repro_torch.train.step import (build_decode_step,
                                    build_paged_decode_step,
                                    build_prefill_chunk_step,
                                    build_prefill_step)

torch.set_num_threads(1)
ATOL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCH = "qwen3-moe-30b-a3b"
#: JAX's side compiled once per shape (eager dispatch is op by op)
j_moe_ffn = jax.jit(jmoe.moe_ffn,
                    static_argnames=("k", "capacity_factor", "act"))


def _close(t, j, atol=1e-5):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


def _moe_inputs(N, d=16, E=8, f=24, seed=0, hot=None):
    """x [N, d], w_router [d, E] f32, expert weights; with ``hot`` every
    token's router logit for that expert is raised by 8 (one expert
    takes every token's top choice)."""
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (N, d)).astype(np.float32)
    w_router = r.normal(0, 0.5, (d, E)).astype(np.float32)
    if hot is not None:
        x[:, 0] = 1.0 + np.abs(x[:, 0])        # positive on one axis ...
        w_router[0, hot] = 8.0                 # ... that one expert reads
    w_gate = r.normal(0, d ** -0.5, (E, d, f)).astype(np.float32)
    w_up = r.normal(0, d ** -0.5, (E, d, f)).astype(np.float32)
    w_down = r.normal(0, f ** -0.5, (E, f, d)).astype(np.float32)
    return x, w_router, w_gate, w_up, w_down


def _both(arrs, k, bf16=False):
    """(port MoEOutput with aux, JAX MoEOutput) of the same inputs, in f32
    or bf16; the router stays f32, as in the model's param tree."""
    x, wr, wg, wu, wd = arrs
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    t = tmoe.moe_ffn(torch.from_numpy(x).to(tdt), torch.from_numpy(wr),
                     *(torch.from_numpy(a).to(tdt) for a in (wg, wu, wd)),
                     k=k, capacity_factor=1.25, with_aux=True)
    j = j_moe_ffn(jnp.asarray(x, jdt), jnp.asarray(wr),
                  *(jnp.asarray(a, jdt) for a in (wg, wu, wd)),
                  k=k, capacity_factor=1.25)
    return t, j


def test_router_topk_and_load_balance_loss_match_jax():
    r = np.random.default_rng(1)
    logits = r.normal(0, 2, (13, 8)).astype(np.float32)
    tw, ti = tmoe.router_topk(torch.from_numpy(logits), 3)
    jw, ji = jmoe.router_topk(jnp.asarray(logits), 3)
    _close(tw, jw, 1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    _close(tmoe.load_balance_loss(torch.from_numpy(probs), ti, 8),
           jmoe.load_balance_loss(jnp.asarray(probs), ji, 8), 1e-6)


def test_moe_ffn_random_routing_matches_jax():
    t, j = _both(_moe_inputs(40, seed=2), k=2)
    _close(t.y, j.y)
    _close(t.aux_loss, j.aux_loss, 1e-6)
    _close(t.fraction_dropped, j.fraction_dropped, 1e-6)


def test_moe_ffn_forced_overflow_zeroes_the_last_kept_slot():
    """k = 1, every token routed to expert 3: C = 8 slots for 24 tokens.
    Tokens 0..6 get expert 3's output, token 7 (slot C-1) gets 0 because
    the dropped tokens' zeros land on its slot after it (the JAX result),
    tokens 8.. are dropped."""
    arrs = _moe_inputs(24, hot=3, seed=3)
    t, j = _both(arrs, k=1)
    C = tmoe.capacity(24, 1, 1.25, 8)
    assert C == 8
    jy = np.asarray(j.y)
    assert np.all(np.abs(jy[:C - 1]).max(-1) > 0)
    assert not jy[C - 1:].any()
    _close(t.y, j.y)
    assert not t.y[C - 1:].any()
    _close(t.fraction_dropped, j.fraction_dropped, 1e-6)
    assert float(t.fraction_dropped) == pytest.approx(16 / 24)


@pytest.mark.parametrize("N", [1, 3, 7, 16, 33, 64, 100])
def test_moe_ffn_capacity_over_token_counts_matches_jax(N):
    """One hot expert takes every token's first choice, so it overflows
    wherever N exceeds C and the drops follow the capacity formula."""
    t, j = _both(_moe_inputs(N, hot=5, seed=10 + N), k=2)
    _close(t.y, j.y)
    _close(t.fraction_dropped, j.fraction_dropped, 1e-6)
    want = -(-max(int(N * 2 * 1.25 / 8), 1) // 8) * 8
    assert tmoe.capacity(N, 2, 1.25, 8) == want


def test_moe_ffn_bf16_matches_jax():
    t, j = _both(_moe_inputs(40, seed=4), k=2, bf16=True)
    assert t.y.dtype == torch.bfloat16
    _close(t.y, np.asarray(j.y, np.float32), 3e-2)


def test_moe_ffn_without_aux_computes_no_loss():
    x, wr, wg, wu, wd = (torch.from_numpy(a) for a in _moe_inputs(9))
    out = tmoe.moe_ffn(x, wr, wg, wu, wd, k=2, capacity_factor=1.25)
    assert out.aux_loss is None and out.fraction_dropped is None
    full = tmoe.moe_ffn(x, wr, wg, wu, wd, k=2, capacity_factor=1.25,
                        with_aux=True)
    assert torch.equal(out.y, full.y)


@functools.lru_cache(maxsize=None)
def _setup(d_ff=0):
    """Configs and bridged f32 weights, made once per ``d_ff`` (no step
    writes the weights)."""
    jcfg = j_get_config(ARCH, smoke=True).replace(**F32, d_ff=d_ff)
    tcfg = t_get_config(ARCH, smoke=True).replace(**F32, d_ff=d_ff)
    jp = jm.init(jcfg, jax.random.key(0))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("d_ff", [0, 48])
def test_moe_block_matches_jax(d_ff):
    """Layer 1's MoE block; with ``d_ff > 0`` the spec tree carries a
    shared dense expert (no config in the repo sets one for moe)."""
    jcfg, tcfg, jp, tp = _setup(d_ff)
    pick = lambda tree: {k: v[1] for k, v in tree.items()}  # noqa: E731
    jshared = pick(jp["blocks"]["shared_mlp"]) if d_ff else None
    tshared = pick(tp["blocks"]["shared_mlp"]) if d_ff else None
    x = np.random.default_rng(6).normal(0, 1, (2, 5, jcfg.d_model)) \
        .astype(np.float32)
    jy, jaux = jax.jit(lambda p, x, sh: jm.moe_block(p, jcfg, x, sh))(
        pick(jp["blocks"]["moe"]), jnp.asarray(x), jshared)
    tx, ty, taux = tm.moe_block(pick(tp["blocks"]["moe"]), tcfg,
                                torch.from_numpy(x), tshared, with_aux=True)
    _close(tx + ty, jy)     # the port leaves the residual add to the next norm
    _close(taux, jaux, 1e-6)
    assert tm.moe_block(pick(tp["blocks"]["moe"]), tcfg,
                        torch.from_numpy(x), tshared)[2] is None


def test_prefill_then_decode_match_jax():
    jcfg, tcfg, jp, tp = _setup()
    r = np.random.default_rng(5)
    B, S, max_len = 2, 11, 24
    toks = r.integers(3, jcfg.vocab_size, (B, S)).astype(np.int32)
    lj, jc = jax.jit(lambda p, b: jm.prefill(p, jcfg, b, max_len))(
        jp, {"tokens": jnp.asarray(toks)})
    lt, tc = build_prefill_step(tcfg, max_len)(
        tp, {"tokens": torch.from_numpy(toks).long()})
    _close(lt, lj, ATOL)
    dec_j = jax.jit(lambda p, c, t: jm.decode_step(p, jcfg, c, t))
    dec_t = build_decode_step(tcfg)
    token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for _ in range(4):
        lj, jc = dec_j(jp, jc, jnp.asarray(token))
        lt, tc = dec_t(tp, tc, torch.from_numpy(token).long())
        _close(lt, lj, ATOL)
        assert int(tc["len"]) == int(jc["len"])
        token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    n = int(jc["len"])
    for key in ("k", "v"):
        _close(tc[key][:, :, :n], np.asarray(jc[key])[:, :, :n], ATOL)
        assert not tc[key][:, :, n:].any()


def test_prefill_chunks_then_paged_decode_match_jax():
    """Two prefill chunks over a shuffled page table with one inactive
    row, then four paged decode steps (the JAX package serves moe on its
    paged main path)."""
    jcfg, tcfg, jp, tp = _setup()
    r = np.random.default_rng(7)
    B, page, num_pages, C = 3, 4, 16, 6
    prompt_lens = [10, 7, 0]                     # row 2 stays inactive
    prompts = [r.integers(3, jcfg.vocab_size, n) for n in prompt_lens]
    perm = list(r.permutation(np.arange(1, num_pages)))
    table = np.zeros((B, num_pages - 1), np.int32)
    for b in range(2):
        table[b, :4] = [perm.pop() for _ in range(4)]
    jc = jm.init_paged_cache(jcfg, B, num_pages, page)
    tc = tm.init_paged_cache(tcfg, B, num_pages, page, device="cpu")
    jc["table"], tc["table"] = jnp.asarray(table), torch.from_numpy(table)
    chunk_j = jax.jit(lambda p, c, *a: jm.prefill_chunk(p, jcfg, c, *a))
    chunk_t = build_prefill_chunk_step(tcfg)
    active = np.asarray([True, True, False])
    lens = np.zeros(B, np.int32)
    for s0 in (0, C):
        toks = np.full((B, C), 3, np.int32)
        cl = np.zeros(B, np.int32)
        for b in range(2):
            seg = prompts[b][s0:s0 + C]
            toks[b, :len(seg)], cl[b] = seg, len(seg)
        start = np.asarray([s0, s0, 0], np.int32)
        jc["lens"], tc["lens"] = jnp.asarray(lens), torch.from_numpy(lens)
        lj, jc = chunk_j(jp, jc, jnp.asarray(toks), jnp.asarray(start),
                         jnp.asarray(cl), jnp.asarray(active))
        lt, tc = chunk_t(tp, tc, torch.from_numpy(toks).long(),
                         torch.from_numpy(start), torch.from_numpy(cl),
                         torch.from_numpy(active))
        _close(lt[:2], np.asarray(lj)[:2], ATOL)
        lens = np.array(jc["lens"])
    dec_j = jax.jit(lambda p, c, t, a: jm.decode_step_paged(p, jcfg, c, t,
                                                            a))
    dec_t = build_paged_decode_step(tcfg)
    token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for _ in range(4):
        lj, jc = dec_j(jp, jc, jnp.asarray(token), jnp.asarray(active))
        lt, tc = dec_t(tp, tc, torch.from_numpy(token).long(),
                       torch.from_numpy(active))
        _close(lt[:2], np.asarray(lj)[:2], ATOL)
        np.testing.assert_array_equal(tc["lens"].numpy(),
                                      np.asarray(jc["lens"]))
        token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    final = np.asarray(jc["lens"])
    assert list(final) == [14, 11, 0]
    for key in ("k", "v"):
        jpool, tpool = np.asarray(jc[key]), tc[key].numpy()
        for b, n in enumerate(final):
            for pos in range(n):
                pid, off = table[b, pos // page], pos % page
                _close(torch.from_numpy(tpool[:, pid, off]),
                       jpool[:, pid, off], ATOL)


def test_bridge_keeps_the_f32_router_of_a_bf16_tree():
    jcfg = j_get_config(ARCH, smoke=True)
    jp = jm.init(jcfg, jax.random.key(1))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    moe = tp["blocks"]["moe"]
    assert moe["w_router"].dtype == torch.float32
    assert moe["w_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        moe["w_router"].numpy(), np.asarray(jp["blocks"]["moe"]["w_router"]))
    np.testing.assert_array_equal(
        moe["w_gate"].view(torch.int16).numpy(),
        np.asarray(jp["blocks"]["moe"]["w_gate"]).view(np.int16))
