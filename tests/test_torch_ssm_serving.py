"""SSM (mamba2) and hybrid (zamba2) serving through the engine, the
port against the JAX package on the CPU in f32 with bridged weights:
``TorchBackend`` under the port's Engine against ``JaxBackend`` under
the JAX package's Engine (same prompts and token streams, with
mid-stream joins and a preemption), and the serving CLI on the CPU (the
paged backend still refuses both families, as the JAX package's does).
"""
import jax
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
from repro_torch.models.params import from_jax
from repro_torch.sched import ResourceVector as TBudget
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingDemand as TDemand
from repro_torch.serve import TorchBackend
from test_torch_dense_serving import _run

torch.set_num_threads(1)
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = ["mamba2-780m", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_token_streams_match_jax_with_joins_and_preemption(arch):
    """Staggered arrivals under a tight budget: mid-stream joins (the
    batch bucket grows, SSM/conv states and KV move along axis 1), a
    preemption with full-context recompute on rejoin, and removals."""
    jcfg = j_get_config(arch, smoke=True).replace(**F32)
    tcfg = t_get_config(arch, smoke=True).replace(**F32)
    jp = jm.init(jcfg, jax.random.key(0))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    kw = dict(max_len=32, sync=1, seed=1)
    jbe = JaxBackend(jcfg, params=jp, **kw)
    tbe = TorchBackend(tcfg, params=tp, device="cpu", **kw)
    joins = []
    tjoin = tbe.join

    def join(reqs, now):               # record (occupied slots, joiners)
        joins.append((len(tbe._slots), len(reqs)))
        return tjoin(reqs, now)
    tbe.join = join
    js_, jreqs = _run(JEngine, JRequest, JDemand, JBudget, jbe)
    ts_, treqs = _run(TEngine, TRequest, TDemand, TBudget, tbe)
    assert ts_["completed"] == js_["completed"] == 8
    assert ts_["preemptions"] == js_["preemptions"] > 0
    assert sum(n_old > 0 for n_old, _ in joins) >= 2    # mid-stream joins
    jtok = {r.rid: (list(r.prompt), list(r.tokens)) for r in jreqs}
    ttok = {r.rid: (list(r.prompt), list(r.tokens)) for r in treqs}
    assert ttok == jtok
    assert tbe.empty and tbe._cache is None



@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_ssm_families_on_the_cpu(arch):
    out = t_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--backend", "dense", "--requests", "4",
                        "--prompt-len", "24", "--decode-steps", "4"])
    assert out["summary"]["completed"] == 4
    be = out["backends"][0]
    assert be.prefill_calls > 0 and be.decode_calls > 0
    with pytest.raises(NotImplementedError, match="dense-stack families"):
        t_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "2", "--decode-steps", "2"])


def test_cli_ssm_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.main(["--arch", "mamba2-780m", "--smoke", "--backend",
                      "dense"])
