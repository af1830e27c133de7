"""The port's GPipe pipeline (``repro_torch.launch.pipeline``) over 4
gloo ranks against the JAX package's ``pipeline_apply`` on 4 host
devices and against sequential stage application, within 1e-5: 2 stages
on a (2, 2) (pipe, dp) mesh and 4 on a (4, 1) one, the stage parameters
held as each rank's slice and as DTensors sharded over 'pipe'; the
output, and the gradients of sum(y * r) for each rank's stage and for x
against ``jax.grad`` through JAX's ``pipeline_apply`` and against
autograd through sequential application.  One spawn of the ranks and one
JAX process serve the whole file."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import scaleout_ranks  # noqa: E402

torch.set_num_threads(1)
N_MICRO, MB, D = 6, 2, 16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    z = {"W": rng.normal(0, 0.3, (4, D, D)), "b": rng.normal(0, 0.1, (4, D)),
         "x": rng.normal(0, 1, (N_MICRO, MB, D)),
         "r": rng.normal(0, 1, (N_MICRO, MB, D))}
    z = {n: a.astype(np.float32) for n, a in z.items()}
    np.savez(tmp / "in.npz", **z)
    proc = scaleout_ranks.jax_process("pipeline", tmp / "in.npz",
                                      tmp / "jax.npz")
    try:
        ranks = scaleout_ranks.spawn("pipeline_rank", tmp,
                                     str(tmp / "in.npz"))
    finally:
        ref = scaleout_ranks.jax_result(proc, tmp / "jax.npz")
    return z, ranks, ref


def _sequential(z, stages):
    y = z["x"]
    for s in range(stages):
        y = np.tanh(y @ z["W"][s] + z["b"][s])
    return y


def _sequential_grads(z, stages):
    """Autograd through the stages applied in sequence: the gradients
    of sum(y * r) for W[:stages], b[:stages] and x."""
    W, b, x = (torch.from_numpy(z[n][:stages] if n != "x" else z[n])
               .requires_grad_(True) for n in ("W", "b", "x"))
    y = x
    for s in range(stages):
        y = torch.tanh(y @ W[s] + b[s])
    torch.sum(y * torch.from_numpy(z["r"])).backward()
    return {"W": W.grad.numpy(), "b": b.grad.numpy(), "x": x.grad.numpy()}


@pytest.mark.parametrize("held", ["", "_dtensor"], ids=["slice", "dtensor"])
@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_equals_jax_and_sequential(runs, stages, held):
    z, ranks, ref = runs
    outs = [r[f"pipe{stages}{held}"].numpy() for r in ranks]
    for y in outs:                       # every rank returns the whole
        np.testing.assert_array_equal(y, outs[0])
    np.testing.assert_allclose(outs[0], ref[f"pipe{stages}"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(outs[0], _sequential(z, stages), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("held", ["", "_dtensor"], ids=["slice", "dtensor"])
@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_gradients_equal_jax_grad_and_sequential(runs, stages,
                                                           held):
    """Each rank's stage gradients and every rank's (whole) x gradient,
    within 1e-5 of ``jax.grad`` through JAX's pipeline and of autograd
    through sequential application (4 stages, 6 microbatches)."""
    z, ranks, ref = runs
    seq = _sequential_grads(z, stages)
    key = f"pipe{stages}{held}"
    for r in ranks:
        s = r[f"stage{stages}"]
        for n in ("W", "b"):
            got = r[f"{key}_g{n}"].numpy()
            for want in (ref[f"pipe{stages}_g{n}"][s], seq[n][s]):
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        for want in (ref[f"pipe{stages}_gx"], seq["x"]):
            np.testing.assert_allclose(r[f"{key}_gx"].numpy(), want,
                                       atol=1e-5, rtol=0)
