"""MoE serving (qwen3-moe smoke) through the engine, the port against the
JAX package on the CPU in f32 with bridged weights: ``TorchPagedBackend``
against ``PagedJaxBackend`` and ``TorchBackend`` against ``JaxBackend``,
each under its package's Engine with the same requests and budget
(staggered mid-stream joins, a preemption with recompute), must give the
same prompts and token streams; and the serving CLI on the CPU with both
backends.  Padding and inactive rows take expert capacity in both
packages alike (the capacity follows the padded token count)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.sched import ResourceVector as JBudget
from repro.serve import Engine as JEngine
from repro.serve import JaxBackend, PagedJaxBackend
from repro.serve import Request as JRequest
from repro.serve import ServingDemand as JDemand
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import serve as t_serve
from repro_torch.models.params import from_jax
from repro_torch.sched import ResourceVector as TBudget
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingDemand as TDemand
from repro_torch.serve import TorchBackend, TorchPagedBackend, pages_for
from test_torch_dense_serving import _run as _run_dense
from test_torch_serving import _run as _run_paged

torch.set_num_threads(1)
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCH = "qwen3-moe-30b-a3b"


@functools.lru_cache(maxsize=None)
def _setup():
    """Configs and bridged f32 weights, made once (no backend writes the
    weights)."""
    jcfg = j_get_config(ARCH, smoke=True).replace(**F32)
    tcfg = t_get_config(ARCH, smoke=True).replace(**F32)
    jp = jm.init(jcfg, jax.random.key(0))
    return jcfg, tcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def _streams(reqs):
    return {r.rid: (list(r.prompt), list(r.tokens)) for r in reqs}


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_token_streams_match_jax_with_joins_and_preemption(backend):
    jcfg, tcfg, jp, tp = _setup()
    if backend == "paged":
        kw = dict(num_pages=1 + 8 * pages_for(32, 4), page_size=4,
                  prefill_chunk=8, seed=1)
        jbe = PagedJaxBackend(jcfg, params=jp, **kw)
        tbe = TorchPagedBackend(tcfg, params=tp, device="cpu", **kw)
        run = _run_paged
    else:
        kw = dict(max_len=32, sync=1, seed=1)
        jbe = JaxBackend(jcfg, params=jp, **kw)
        tbe = TorchBackend(tcfg, params=tp, device="cpu", **kw)
        run = _run_dense
    joins = []
    tjoin = tbe.join

    def join(reqs, now):               # record (running requests, joiners)
        joins.append((len(tbe._slots), len(reqs)))
        return tjoin(reqs, now)
    tbe.join = join
    js, jreqs = run(JEngine, JRequest, JDemand, JBudget, jbe)
    ts, treqs = run(TEngine, TRequest, TDemand, TBudget, tbe)
    assert ts["completed"] == js["completed"] == 8
    assert ts["preemptions"] == js["preemptions"] > 0
    assert sum(n_old > 0 for n_old, _ in joins) >= 2    # mid-stream joins
    assert _streams(treqs) == _streams(jreqs)
    for r in treqs:
        assert len(r.tokens) == r.max_new_tokens
    assert tbe.prefill_calls > 0 and tbe.decode_calls > 0


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_cli_serves_moe_on_the_cpu(backend):
    out = t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--backend", backend, "--requests", "4",
                        "--prompt-len", "24", "--decode-steps", "4"])
    assert out["summary"]["completed"] == 4
    assert out["summary"]["forced_steps"] == 0
    be = out["backends"][0]
    assert be.device.type == "cpu"
    assert be.prefill_calls > 0 and be.decode_calls > 0
    for r in out["engine"].requests:
        assert len(r.tokens) == r.max_new_tokens
