"""Shared by the dense-cache serving tests of the remaining families
(test_torch_gemma2.py, test_torch_encdec.py, test_torch_pixtral.py):
the JAX and port configs of an arch's smoke size in f32 with params
drawn by JAX and bridged bit for bit, one model step each side, the
comparison of a cache tree, the norm ops' calls counted per model call,
and ``TorchBackend`` under the port's Engine against ``JaxBackend``
under the JAX package's Engine on the same requests.

Bound: ``ATOL`` (1e-4), as test_torch_dense_serving.py holds the other
families: a few layers of f32 matmuls and softmaxes summed in another
order stay well inside it."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.sched import ResourceVector as JBudget
from repro.serve import Engine as JEngine
from repro.serve import JaxBackend
from repro.serve import Request as JRequest
from repro.serve import ServingDemand as JDemand
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels.rmsnorm import ops as t_ops
from repro_torch.models.params import from_jax
from repro_torch.sched import ResourceVector as TBudget
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingDemand as TDemand
from repro_torch.serve import TorchBackend

ATOL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")
#: the norm ops of the model, by name in ``kernels/rmsnorm/ops.py`` (on
#: the card each launches the kernel of the same name + ``_fwd``)
NORM_OPS = ("rmsnorm", "add_rmsnorm", "qk_norm_rope", "gated_rmsnorm")


def setup(arch):
    """(JAX cfg, port cfg, JAX params, bridged port params) of the arch's
    smoke size in f32."""
    jcfg = j_get_config(arch, smoke=True).replace(**F32)
    tcfg = t_get_config(arch, smoke=True).replace(**F32)
    jp = jm.init(jcfg, jax.random.key(0))
    return jcfg, tcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def prompt_batch(cfg, B, S):
    """(JAX batch, port batch) of B prompts of S tokens, with the vlm's 4
    patch embeddings or the encdec's 8 encoder frames, from numpy."""
    r = np.random.default_rng(5)
    toks = r.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.from_numpy(toks).long()}
    extra = {"vlm": ("patch_embeds", 4), "encdec": ("enc_embeds", 8)}
    if cfg.family in extra:
        key, n = extra[cfg.family]
        e = r.normal(0, 0.02, (B, n, cfg.d_model)).astype(np.float32)
        jb[key], tb[key] = jnp.asarray(e), torch.from_numpy(e)
    return jb, tb


def assert_close(t, j, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=ATOL,
                               rtol=ATOL, err_msg=what)


def assert_caches_close(tc, jc):
    """Every leaf of the two cache trees: the same keys and shapes, every
    element within ``ATOL``."""
    assert sorted(tc) == sorted(jc)
    for key in jc:
        t, j = tc[key].numpy(), np.asarray(jc[key])
        assert t.shape == j.shape, key
        assert_close(t, j, key)


def counting_norm_ops(monkeypatch):
    """Count each norm op's calls (the wrappers the model reaches, each
    one kernel launch on the card): -> the live ``{op: calls}`` dict."""
    calls = {op: 0 for op in NORM_OPS}

    def counted(op):
        real = getattr(t_ops, op)

        def call(*a, **k):
            calls[op] += 1
            return real(*a, **k)
        return call

    for op in NORM_OPS:
        monkeypatch.setattr(t_ops, op, counted(op))
    return calls


def requests(cls, specs):
    """Requests of ``specs``: (prompt_len, max_new_tokens, arrival)."""
    return [cls(rid=i, prompt_len=p, max_new_tokens=n, arrival=a)
            for i, (p, n, a) in enumerate(specs)]


def staggered():
    """8 requests drawn as test_torch_dense_serving.py draws them: 4-15
    prompt tokens, 4-9 new tokens, arriving 1 ms apart (mid-stream joins
    at the shared position, growing the batch bucket from 1 to 8)."""
    rng = np.random.default_rng(1)
    return [(int(rng.integers(4, 16)), int(rng.integers(4, 10)), i * 1e-3)
            for i in range(8)]


def run_both(arch, specs, max_len, *, hbm_tokens=64.0):
    """The same requests through ``JaxBackend`` and ``TorchBackend`` (on
    the CPU) with bridged f32 weights, under a budget of ``hbm_tokens``
    tokens of KV (a tight one preempts).  Returns ((JAX summary, JAX
    requests), (port summary, port requests), the port backend, the
    (occupied slots, joiners) of each port join, and the port backend's
    position at each decode step)."""
    jcfg, tcfg, jp, tp = setup(arch)
    kw = dict(max_len=max_len, sync=1, seed=1)
    jbe = JaxBackend(jcfg, params=jp, **kw)
    tbe = TorchBackend(tcfg, params=tp, device="cpu", **kw)
    joins, positions = [], []
    tjoin, tdecode = tbe.join, tbe.decode

    def join(reqs, now):
        joins.append((len(tbe._slots), len(reqs)))
        return tjoin(reqs, now)

    def decode(running):
        positions.append(tbe.position)
        return tdecode(running)
    tbe.join, tbe.decode = join, decode

    def run(engine_cls, req_cls, demand_cls, budget_cls, backend):
        sd = demand_cls(weights_gb=0.01, kv_gb_per_token=1e-4)
        budget = budget_cls(hbm=0.01 + 1e-4 * hbm_tokens)
        eng = engine_cls(requests(req_cls, specs), sd, budget, backend,
                         max_batch=8)
        return eng.run(), eng.requests

    j = run(JEngine, JRequest, JDemand, JBudget, jbe)
    t = run(TEngine, TRequest, TDemand, TBudget, tbe)
    return j, t, tbe, joins, positions


def streams(reqs):
    return {r.rid: (list(r.prompt), list(r.tokens)) for r in reqs}
