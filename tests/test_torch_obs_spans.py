"""The port's spans and work counters (``repro_torch.obs.spans``) on the
CPU: with no profiler running a span is the shared no-op and a paged
serve opens none; under ``torch.profiler`` the named ranges appear and
nest as the program's layers do (one attention and one FFN block per
layer per model call, the MoE phases inside the MoE block, the train
step's forward, backward with the recompute inside it, and optimizer);
the counters equal the formulas of the calls' shapes; and the served
tokens are the same with the profiler running."""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import TrainConfig, get_config
from repro_torch.models import model as model_lib
from repro_torch.models.moe import capacity
from repro_torch.obs import spans
from repro_torch.obs.spans import COUNTERS
from repro_torch.serve import Request, TorchPagedBackend, pages_for
from repro_torch.train.optim import init_opt_state
from repro_torch.train.step import build_train_step

torch.set_num_threads(1)
ARCHS = ["qwen3-0.6b", "qwen3-moe-30b-a3b"]
PAGE, CHUNK = 4, 8
FFN = {"qwen3-0.6b": "model.mlp", "qwen3-moe-30b-a3b": "model.moe"}


def _backend(arch, seed=1):
    cfg = get_config(arch, smoke=True)
    return TorchPagedBackend(cfg, num_pages=1 + 4 * pages_for(32, PAGE),
                             page_size=PAGE, prefill_chunk=CHUNK, seed=seed,
                             device="cpu")


def _requests(n=3, prompt=10, new=3):
    """Prompts of ``prompt`` tokens: one chunk call at the join, the
    prompt's rest in a second, then decode calls."""
    return [Request(rid=i, prompt_len=prompt + i, max_new_tokens=new)
            for i in range(n)]


def _serve(be, reqs, decodes=1):
    """Join (the first chunk call), then ``decodes`` engine steps."""
    be.join(reqs, 0.0)
    for _ in range(decodes):
        be.decode(reqs)


def _ranges(prof):
    """Program ranges of a trace: name -> [(start, end, thread)]."""
    out = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if "." in e.name() and "::" not in e.name():
            s = e.start_ns()
            out[e.name()].append((s, s + e.duration_ns(),
                                  e.start_thread_id()))
    return out


def _inside(inner, outer):
    """Every range of ``inner`` lies inside one of ``outer``."""
    return all(any(s0 <= s and t <= t0 for s0, t0, _ in outer)
               for s, t, _ in inner)


def _delta(before):
    return {k: v - before.get(k, 0.0) for k, v in COUNTERS.counters.items()
            if v != before.get(k, 0.0)}


def test_span_without_profiler_is_the_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert spans.span("model.attn") is spans.OFF
    assert spans.span("serve.decode_call") is spans.OFF
    with spans.span("model.attn") as inner:
        assert inner is None

    @spans.spanned("model.mlp")
    def f(a, *, b):
        return a + b
    assert f(1, b=2) == 3 and f.__name__ == "f"


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_opens_no_range_without_profiler(arch, monkeypatch):
    opened = []

    def fake(name):
        opened.append(name)
        return spans.OFF
    monkeypatch.setattr(spans, "_range", fake)
    _serve(_backend(arch), _requests(), decodes=2)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(_backend(arch), _requests(), decodes=2)
    assert "serve.prefill_call" in opened and "model.attn" in opened


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_spans_nest_as_the_layers(arch):
    be = _backend(arch)
    L = be.cfg.num_layers
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(be, _requests(), decodes=2)
    r = _ranges(prof)
    calls = be.prefill_calls + be.decode_calls
    assert be.prefill_calls == 2 and be.decode_calls == 1
    assert len(r["serve.prefill_call"]) == be.prefill_calls
    assert len(r["serve.decode_call"]) == be.decode_calls
    # one attention and one FFN block per layer per model call, one
    # unembedding, preparation and read-back per call
    assert len(r["model.attn"]) == len(r[FFN[arch]]) == L * calls
    for name in ("model.unembed", "serve.prepare", "serve.readback"):
        assert len(r[name]) == calls, name
    model_calls = r["serve.prefill_call"] + r["serve.decode_call"]
    for name in ("model.attn", FFN[arch], "model.unembed", "serve.prepare",
                 "serve.readback"):
        assert _inside(r[name], model_calls), name
    moe = ["moe.router", "moe.dispatch", "moe.experts", "moe.combine"]
    for name in moe:
        assert len(r[name]) == len(r["model.moe"]), name
        assert _inside(r[name], r["model.moe"]), name
    assert not any(n.startswith("chipbench/") for n in r)


@pytest.mark.parametrize("arch", ARCHS)
def test_counters_equal_the_shape_formulas(arch):
    be = _backend(arch)
    cfg = be.cfg
    L = cfg.num_layers
    reqs = _requests()
    before = dict(COUNTERS.counters)
    be.join(reqs, 0.0)                       # chunk call 1: 8 of each
    cap, maxp = be._cap, be._maxp
    first = _delta(before)
    assert first["serve.tokens_computed"] == cap * CHUNK
    assert first["serve.tokens_useful"] == CHUNK * len(reqs)
    # every row's whole page table, every layer
    assert first["attn.kv_gathered"] == L * cap * maxp * PAGE
    # a prefilling row attends its chunk's end; the others none
    assert first["attn.kv_live"] == L * CHUNK * len(reqs)
    before = dict(COUNTERS.counters)
    be.decode(reqs)                          # chunk call 2: the rest
    be.decode(reqs)                          # decode call
    rest = [r.prompt_len - CHUNK for r in reqs]
    d = _delta(before)
    assert d["serve.tokens_computed"] == cap * CHUNK
    assert d["serve.tokens_useful"] == sum(rest)
    assert d["attn.kv_gathered"] == L * cap * maxp * PAGE
    assert d["attn.kv_live"] == L * sum(r.prompt_len for r in reqs)
    if cfg.family != "moe":
        assert "moe.pairs_routed" not in d
        return
    E, k = cfg.num_experts, cfg.experts_per_token
    # every position of the padded call is routed, the decode call's too
    n_tokens = [cap * CHUNK, cap * CHUNK, cap]
    both = {**first, **{key: first.get(key, 0) + d.get(key, 0)
                        for key in d}}
    assert both["moe.pairs_routed"] == L * k * sum(n_tokens)
    assert both["moe.slots_computed"] == L * E * sum(
        capacity(n, k, cfg.capacity_factor, E) for n in n_tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_are_the_same_under_the_profiler(arch):
    def tokens(profiled):
        be, reqs = _backend(arch, seed=3), _requests(n=4, new=4)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                _serve(be, reqs, decodes=5)
        else:
            _serve(be, reqs, decodes=5)
        return [list(r.tokens) for r in reqs]
    plain = tokens(False)
    assert all(len(t) == 4 for t in plain)
    assert tokens(True) == plain


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_spans_forward_backward_optimizer(arch):
    cfg = get_config(arch, smoke=True).replace(remat="full")
    gen = torch.Generator().manual_seed(0)
    params = model_lib.init(cfg, gen, "cpu")
    tc = TrainConfig(warmup_steps=1, total_steps=4)
    opt = init_opt_state(params, tc)
    step = build_train_step(cfg, tc)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    batch = {"tokens": tok, "labels": tok}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            params, opt, _ = step(params, opt, batch)
    r = _ranges(prof)
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert len(r[name]) == 2, name
    L = cfg.num_layers
    # the forward's blocks, and the recompute's inside the backward
    attn = r["model.attn"]
    assert len(attn) == 2 * 2 * L
    fwd = [a for a in attn if _inside([a], r["train.forward"])]
    bwd = [a for a in attn if _inside([a], r["train.backward"])]
    assert len(fwd) == len(bwd) == 2 * L
    assert _inside(r[FFN[arch]], r["train.forward"] + r["train.backward"])
