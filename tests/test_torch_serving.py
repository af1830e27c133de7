"""Serving parity: the port's Engine + TorchPagedBackend (on the CPU)
against the JAX package's Engine + PagedJaxBackend with the same bridged
f32 weights, requests and budget, and the port's serving CLI."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.serve import Engine as JEngine
from repro.serve import PagedJaxBackend
from repro.serve import Request as JRequest
from repro.serve import ServingDemand as JDemand
from repro.sched import ResourceVector as JBudget
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import serve as t_serve
from repro_torch.models.params import from_jax
from repro_torch.sched import ResourceVector as TBudget
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingDemand as TDemand
from repro_torch.serve import TorchPagedBackend, pages_for

torch.set_num_threads(1)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _requests(cls):
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt_len=int(rng.integers(4, 20)),
                max_new_tokens=int(rng.integers(4, 10)),
                arrival=float(i) * 1e-3) for i in range(8)]


def _run(engine_cls, req_cls, demand_cls, budget_cls, backend):
    """Staggered arrivals and a tight budget (as in the JAX package's
    paged preemption test): mid-stream joins, eviction and full-context
    recompute on rejoin."""
    sd = demand_cls(weights_gb=0.01, kv_gb_per_token=1e-4, page_size=4)
    budget = budget_cls(hbm=0.01 + 1e-4 * 32 * 2.0)
    eng = engine_cls(_requests(req_cls), sd, budget, backend, max_batch=8)
    summary = eng.run()
    return summary, eng.requests


def test_token_streams_match_jax_with_preemption():
    jcfg = j_get_config("qwen3-0.6b", smoke=True).replace(**F32)
    tcfg = t_get_config("qwen3-0.6b", smoke=True).replace(**F32)
    jp = jm.init(jcfg, jax.random.key(0))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    kw = dict(num_pages=1 + 8 * pages_for(32, 4), page_size=4,
              prefill_chunk=8, seed=1)
    jbe = PagedJaxBackend(jcfg, params=jp, **kw)
    tbe = TorchPagedBackend(tcfg, params=tp, device="cpu", **kw)
    js, jreqs = _run(JEngine, JRequest, JDemand, JBudget, jbe)
    ts, treqs = _run(TEngine, TRequest, TDemand, TBudget, tbe)
    assert ts["completed"] == js["completed"] == 8
    assert ts["preemptions"] == js["preemptions"] > 0
    jtok = {r.rid: (list(r.prompt), list(r.tokens)) for r in jreqs}
    ttok = {r.rid: (list(r.prompt), list(r.tokens)) for r in treqs}
    for rid in jtok:
        assert ttok[rid] == jtok[rid], rid
    for r in treqs:
        assert len(r.tokens) == r.max_new_tokens
    assert tbe.alloc.allocated_pages == tbe.alloc.reserved_pages == 0
    assert tbe.decode_calls > 0


def test_cli_serves_on_cpu():
    out = t_serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                        "cpu", "--requests", "4", "--decode-steps", "4"])
    assert out["summary"]["completed"] == 4
    assert out["backends"][0].device.type == "cpu"


def test_cli_dense_backend_not_ported_yet():
    """``--backend dense --device cpu`` serves every request through the
    port's TorchBackend (the dense-cache slice has landed)."""
    from repro_torch.serve import TorchBackend
    out = t_serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                        "--backend", "dense", "--requests", "4",
                        "--decode-steps", "4"])
    assert out["summary"]["completed"] == 4
    be = out["backends"][0]
    assert isinstance(be, TorchBackend) and be.device.type == "cpu"
    assert be.prefill_calls > 0 and be.decode_calls > 0
    for r in out["engine"].requests:
        assert len(r.tokens) == r.max_new_tokens


def test_cli_defaults_to_the_card_and_never_falls_back():
    """Without ``--device cpu`` the CLI serves on CUDA; on a machine with
    no card it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.main(["--arch", "qwen3-0.6b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchPagedBackend(t_get_config("qwen3-0.6b", smoke=True))
