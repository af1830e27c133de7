"""Dense-cache serving in the port against the JAX package, on the CPU in
f32 with bridged weights.

* ``prefill`` + ``decode_step`` logits and caches against
  ``repro.models.model`` on qwen3-0.6b smoke (and a vlm), at atol 1e-4
  as in test_torch_model.py: three layers of f32 matmuls and softmaxes
  summed in a different order stay well inside it.
* ``TorchBackend`` under the port's Engine against ``JaxBackend`` under
  the JAX package's Engine: same prompts and token streams, with
  staggered mid-stream joins (bucket growth) and a preemption.
* Torch twins of the JAX backend's pins (join cost charged at the padded
  position, bucket-shrink hysteresis) and of dense == paged token
  streams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.sched import ResourceVector as JBudget
from repro.serve import Engine as JEngine
from repro.serve import JaxBackend
from repro.serve import Request as JRequest
from repro.serve import ServingDemand as JDemand
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import serve as t_serve
from repro_torch.models import model as tm
from repro_torch.models.params import from_jax
from repro_torch.sched import ResourceVector as TBudget
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingDemand as TDemand
from repro_torch.serve import TorchBackend, TorchPagedBackend
from repro_torch.train.step import build_decode_step, build_prefill_step

torch.set_num_threads(1)
ATOL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _setup(arch="qwen3-0.6b", seed=0):
    jcfg = j_get_config(arch, smoke=True).replace(**F32)
    tcfg = t_get_config(arch, smoke=True).replace(**F32)
    jp = jm.init(jcfg, jax.random.key(seed))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "pixtral-12b"])
def test_prefill_then_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    r = np.random.default_rng(5)
    B, S, max_len = 2, 11, 24
    toks = r.integers(3, jcfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.from_numpy(toks).long()}
    if jcfg.family == "vlm":
        pe = r.normal(0, 0.02, (B, 4, jcfg.d_model)).astype(np.float32)
        jb["patch_embeds"], tb["patch_embeds"] = (jnp.asarray(pe),
                                                  torch.from_numpy(pe))
    lj, jc = jax.jit(lambda p, b: jm.prefill(p, jcfg, b, max_len))(jp, jb)
    lt, tc = build_prefill_step(tcfg, max_len)(tp, tb)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=ATOL)
    assert tc["k"].shape == jc["k"].shape == (tcfg.num_layers, B, max_len,
                                              tcfg.num_kv_heads,
                                              tcfg.head_dim)
    assert int(tc["len"]) == int(jc["len"])
    dec_j = jax.jit(lambda p, c, t: jm.decode_step(p, jcfg, c, t))
    dec_t = build_decode_step(tcfg)
    token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)    # [B, 1]
    for _ in range(3):
        lj, jc = dec_j(jp, jc, jnp.asarray(token))
        lt, tc = dec_t(tp, tc, torch.from_numpy(token).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=ATOL)
        assert int(tc["len"]) == int(jc["len"])
        token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    n = int(jc["len"])
    for key in ("k", "v"):     # every written slot, and zeros past them
        np.testing.assert_allclose(tc[key].numpy()[:, :, :n],
                                   np.asarray(jc[key])[:, :, :n], atol=ATOL,
                                   rtol=ATOL)
        assert not tc[key][:, :, n:].any()


@pytest.mark.parametrize("arch", ["gemma2-27b", "whisper-large-v3"])
def test_dense_path_serves_the_remaining_families(arch):
    """Every family serves on the dense path now: gemma2's local/global
    layers and whisper's encoder-decoder prefill and decode like the JAX
    package (test_torch_gemma2.py and test_torch_encdec.py hold every
    cache leaf and the backends' streams)."""
    jcfg, tcfg, jp, tp = _setup(arch)
    toks = np.random.default_rng(5).integers(3, jcfg.vocab_size, (2, 11))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks).long()}
    if jcfg.family == "encdec":
        e = np.random.default_rng(6).normal(0, 0.02, (2, 8, jcfg.d_model))
        jb["enc_embeds"] = jnp.asarray(e, jnp.float32)
        tb["enc_embeds"] = torch.from_numpy(e).float()
    lj, jc = jm.prefill(jp, jcfg, jb, 16)
    lt, tc = tm.prefill(tp, tcfg, tb, 16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=ATOL)
    token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    lj, _ = jm.decode_step(jp, jcfg, jc, jnp.asarray(token))
    lt, _ = tm.decode_step(tp, tcfg, tc, torch.from_numpy(token).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=ATOL)


def _requests(cls):
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt_len=int(rng.integers(4, 16)),
                max_new_tokens=int(rng.integers(4, 10)),
                arrival=float(i) * 1e-3) for i in range(8)]


def _run(engine_cls, req_cls, demand_cls, budget_cls, backend):
    """Staggered arrivals and a tight budget: mid-stream joins at the
    shared position (growing the batch bucket from 1 to 8), a preemption
    with full-context recompute on rejoin, and shrinking removals."""
    sd = demand_cls(weights_gb=0.01, kv_gb_per_token=1e-4)
    budget = budget_cls(hbm=0.01 + 1e-4 * 32 * 2.0)
    eng = engine_cls(_requests(req_cls), sd, budget, backend, max_batch=8)
    summary = eng.run()
    return summary, eng.requests


def test_token_streams_match_jax_with_joins_and_preemption():
    jcfg, tcfg, jp, tp = _setup()
    kw = dict(max_len=32, sync=1, seed=1)
    jbe = JaxBackend(jcfg, params=jp, **kw)
    tbe = TorchBackend(tcfg, params=tp, device="cpu", **kw)
    joins = []
    tjoin = tbe.join

    def join(reqs, now):               # record (occupied slots, joiners)
        joins.append((len(tbe._slots), len(reqs)))
        return tjoin(reqs, now)
    tbe.join = join
    js, jreqs = _run(JEngine, JRequest, JDemand, JBudget, jbe)
    ts, treqs = _run(TEngine, TRequest, TDemand, TBudget, tbe)
    assert ts["completed"] == js["completed"] == 8
    assert ts["preemptions"] == js["preemptions"] > 0
    assert sum(n_old > 0 for n_old, _ in joins) >= 2    # mid-stream joins
    jtok = {r.rid: (list(r.prompt), list(r.tokens)) for r in jreqs}
    ttok = {r.rid: (list(r.prompt), list(r.tokens)) for r in treqs}
    assert ttok == jtok
    for r in treqs:
        assert len(r.tokens) == r.max_new_tokens
    assert tbe.prefill_calls == len(joins) and tbe.decode_calls > 0
    assert tbe.empty and tbe._cache is None


def _smoke_cfg():
    return t_get_config("qwen3-0.6b", smoke=True)


def test_torch_dense_join_cost_golden():
    """Twin of the JAX pin: the backend charges prefill at the PADDED
    position it actually computes (every row prefills to self._pos), not
    the raw prompt length."""
    be = TorchBackend(_smoke_cfg(), max_len=48, sync=8, seed=0,
                      device="cpu")
    cost = be.join([TRequest(rid=0, prompt_len=5, max_new_tokens=30)], 0.0)
    assert be._pos == 8
    assert cost == pytest.approx(be._timer.t_prefill_per_token * 8)
    cost = be.join([TRequest(rid=1, prompt_len=3, max_new_tokens=30)], 0.0)
    assert cost == pytest.approx(be._timer.t_prefill_per_token * 8)


def test_torch_dense_cache_shape_hysteresis():
    """Twin of the JAX pin: removals only re-bucket the batch axis down
    after ``shrink_patience`` consecutive shrink-eligible removals."""
    be = TorchBackend(_smoke_cfg(), max_len=48, sync=8, seed=0,
                      shrink_patience=3, device="cpu")
    rs = [TRequest(rid=10 + i, prompt_len=4, max_new_tokens=40)
          for i in range(5)]
    be.join(rs, 0.0)
    caps = [be._last.shape[0]]
    for r in rs[:4]:
        be.remove([r])
        caps.append(be._last.shape[0])
        assert be._cache["k"].shape[1] == caps[-1]
    # cap 8 holds through 2 removals (streak < patience), shrinks on the
    # 3rd, then holds again
    assert caps == [8, 8, 8, 2, 2]


def test_torch_dense_matches_paged_token_streams():
    """Twin of the JAX migration golden: equal prompt lengths, sync=1 and
    simultaneous arrival make the dense backend prefill with no
    left-pad, so the paged backend (chunked prefill, per-request lengths)
    reproduces its greedy streams exactly."""
    cfg = _smoke_cfg().replace(**F32)
    params = tm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(3, cfg.vocab_size, 11)) for _ in range(4)]

    def run(be):
        reqs = [TRequest(rid=i, prompt_len=11, max_new_tokens=6,
                         arrival=0.0, prompt=list(prompts[i]))
                for i in range(4)]
        eng = TEngine(reqs, TDemand(weights_gb=0.01, kv_gb_per_token=1e-6),
                      TBudget(hbm=100.0), be, max_batch=4)
        assert eng.run()["completed"] == 4
        return {r.rid: list(r.tokens) for r in eng.requests}

    dense = run(TorchBackend(cfg, params=params, max_len=32, sync=1,
                             device="cpu"))
    paged = run(TorchPagedBackend(cfg, params=params, num_pages=1 + 4 * 5,
                                  page_size=4, prefill_chunk=4,
                                  device="cpu"))
    assert paged == dense


def test_torch_backend_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBackend(_smoke_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.main(["--arch", "qwen3-0.6b", "--smoke", "--backend",
                      "dense"])
