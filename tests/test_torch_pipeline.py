"""The port's GPipe pipeline (``repro_torch.launch.pipeline``) over 4
gloo ranks against the JAX package's ``pipeline_apply`` on 4 host
devices and against sequential stage application, within 1e-5: 2 stages
on a (2, 2) (pipe, dp) mesh and 4 on a (4, 1) one, the stage parameters
held as each rank's slice and as DTensors sharded over 'pipe'.  One spawn
of the ranks and one JAX process serve the whole file."""
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
         "x": rng.normal(0, 1, (N_MICRO, MB, D))}
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
