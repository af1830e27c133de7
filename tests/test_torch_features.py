"""The port's feature probe (``repro_torch.core.features``) against the
JAX package's, feature by feature, on the f32 smoke configs of a dense,
an MoE and an SSM model at 2 x 64 tokens, for the train step and the
serve (decode) step.  The JAX side compiles its probe as its
``extract_features`` does and reads the same numbers (``analyze`` of the
HLO, ``memory_analysis``); the port's ``probe_record`` runs its step on
fake tensors.

Held exactly: the matrix-product FLOPs (dense and MoE), the parameter
and argument bytes, the loops and their trip counts (the layer stacks,
the SSD's chunk recurrence, each again in the backward and under remat),
the collective features (no collective on one process, on either
side).  The SSM's FLOPs within 0.1%: the Mamba2 SSD's
three-operand einsum ``bcjh,bcjhn,bcjhp->bchpn`` contracts in another
order in torch than in XLA, which costs 2·B·c·h·p·n more or fewer
multiply-adds per layer.  The output bytes within XLA's tuple index
table, 8 B per output leaf.  Every other feature is a deliberate
difference (eager ops against a fused XLA program; ``NOT_HELD`` says
why): it is held finite, and both values are recorded as the test's
properties."""
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import features as jf
from repro_torch.configs import get_config as torch_config
from repro_torch.core import features as tf

torch.set_num_threads(1)
ARCHS = ["qwen3-0.6b", "qwen3-moe-30b-a3b", "mamba2-780m"]
KINDS = ["train", "decode"]
SEQ, BATCH = 64, 2
F32 = dict(param_dtype="float32", compute_dtype="float32")

#: the features the port defines otherwise, and why
NOT_HELD = {
    "log_hbm_bytes": "every eager op's inputs and outputs, not XLA's "
                     "fused program's",
    "arithmetic_intensity": "FLOPs over the eager bytes",
    "log_temp_bytes": "the peak of the eager ops' live storages, not "
                      "XLA's buffer assignment",
    "temp_to_arg_ratio": "the eager peak over the argument bytes",
    "dot_count": "matrix-product ops; XLA fuses some into one dot",
    "fusion_count": "every non-view eager op (a kernel each)",
    "bytes_per_token": "the eager bytes per token",
    "compute_term_share": "the roofline over the eager bytes",
    "memory_term_share": "the roofline over the eager bytes",
}
COLLECTIVE = ["log_collective_bytes", "coll_allreduce_frac",
              "coll_allgather_frac", "coll_alltoall_frac",
              "coll_permute_frac", "coll_op_count"]


def _jax_record(arch, kind):
    """``repro.core.features.extract_features``'s record, built as it
    builds it, with the number of the step's output leaves."""
    from repro.configs import get_config, input_specs
    from repro.configs.base import ShapeConfig, TrainConfig
    from repro.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16
    from repro.models import model as model_lib
    from repro.train import optim
    from repro.train.step import build_serve_step, build_train_step
    from repro.utils.hlo import count_ops
    from repro.utils.hlo_analyzer import analyze
    cfg = get_config(arch, smoke=True).replace(**F32)
    specs = input_specs(cfg, ShapeConfig("probe", kind, SEQ, BATCH))
    ap = model_lib.abstract(cfg)
    if kind == "train":
        tc = TrainConfig()
        lowered = jax.jit(build_train_step(cfg, tc)).lower(
            ap, optim.abstract_opt_state(ap, tc), specs)
        tokens = BATCH * SEQ
    else:
        lowered = jax.jit(build_serve_step(cfg)).lower(
            ap, specs["token"], specs["cache"])
        tokens = BATCH
    compiled = lowered.compile()
    hlo = compiled.as_text()
    hc, ma = analyze(hlo), compiled.memory_analysis()
    rec = {
        "roofline": {"compute_s": hc.flops / PEAK_FLOPS_BF16,
                     "memory_s": hc.hbm_bytes / HBM_BW,
                     "collective_s": hc.total_collective_bytes / ICI_BW},
        "cost": {"flops_per_device": hc.flops,
                 "hbm_bytes_per_device": hc.hbm_bytes},
        "memory": {"argument_bytes": ma.argument_size_in_bytes,
                   "temp_bytes": ma.temp_size_in_bytes,
                   "output_bytes": ma.output_size_in_bytes},
        "collectives": {"total_bytes": hc.total_collective_bytes,
                        "bytes": hc.collective_bytes,
                        "counts": hc.collective_counts},
        "hlo_ops": count_ops(hlo, ("dot", "fusion", "while")),
        "loops": hc.loops,
        "params_total": sum(int(np.prod(x.shape))
                            for x in jax.tree.leaves(ap)),
        "tokens": tokens,
    }
    return rec, len(jax.tree.leaves(lowered.out_info))


@pytest.fixture(scope="module")
def probes():
    out = {}
    for arch in ARCHS:
        for kind in KINDS:
            port = tf.probe_record(torch_config(arch, smoke=True)
                                   .replace(**F32), kind, SEQ, BATCH)
            jrec, leaves = _jax_record(arch, kind)
            out[arch, kind] = (port, jrec, leaves)
    return out


CASES = [(a, k) for a in ARCHS for k in KINDS]
IDS = [f"{a}-{k}" for a, k in CASES]


def _names(rec, mod):
    return dict(zip(mod.TPU_FEATURE_NAMES, mod.features_from_record(rec)))


@pytest.mark.parametrize("arch,kind", CASES, ids=IDS)
def test_flops_equal_jax(probes, arch, kind):
    port, jrec, _ = probes[arch, kind]
    got = port["cost"]["flops_per_device"]
    want = jrec["cost"]["flops_per_device"]
    if arch == "mamba2-780m" and kind == "train":
        # the SSD einsum's contraction order (module docstring)
        assert got != want and abs(got - want) <= 1e-3 * want, (got, want)
    else:
        assert got == want, (got, want)
    pf, jn = _names(port, tf), _names(jrec, jf)
    for name in ("log_flops", "flops_per_token"):
        tol = 1e-3 / math.log(10) if arch == "mamba2-780m" else 0.0
        assert abs(pf[name] - jn[name]) <= tol, (name, pf[name], jn[name])


@pytest.mark.parametrize("arch,kind", CASES, ids=IDS)
def test_argument_and_param_bytes_equal_jax(probes, arch, kind):
    port, jrec, _ = probes[arch, kind]
    assert port["memory"]["argument_bytes"] == \
        jrec["memory"]["argument_bytes"]
    assert port["params_total"] == jrec["params_total"]
    pf, jn = _names(port, tf), _names(jrec, jf)
    for name in ("log_param_bytes", "log_arg_bytes"):
        assert pf[name] == jn[name], name


@pytest.mark.parametrize("arch,kind", CASES, ids=IDS)
def test_output_bytes_within_the_tuple_table(probes, arch, kind):
    port, jrec, leaves = probes[arch, kind]
    assert port["step_cost"].output_leaves == leaves
    assert jrec["memory"]["output_bytes"] - port["memory"]["output_bytes"] \
        == 8 * leaves


@pytest.mark.parametrize("arch,kind", CASES, ids=IDS)
def test_loops_equal_jax(probes, arch, kind):
    port, jrec, _ = probes[arch, kind]
    assert sorted(lp["trip"] for lp in port["loops"]) == \
        sorted(lp["trip"] for lp in jrec["loops"])
    pf, jn = _names(port, tf), _names(jrec, jf)
    for name in ("while_count", "loop_trip_mean"):
        assert pf[name] == jn[name], (name, pf[name], jn[name])


@pytest.mark.parametrize("arch,kind", CASES, ids=IDS)
def test_no_collective_on_one_process(probes, arch, kind):
    port, jrec, _ = probes[arch, kind]
    pf, jn = _names(port, tf), _names(jrec, jf)
    for name in COLLECTIVE:
        assert pf[name] == jn[name] == 0.0, name


@pytest.mark.parametrize("arch,kind", CASES, ids=IDS)
def test_other_features_finite_and_recorded(probes, arch, kind,
                                            record_property):
    port, jrec, _ = probes[arch, kind]
    pf, jn = _names(port, tf), _names(jrec, jf)
    held = {"log_flops", "flops_per_token", "log_param_bytes",
            "log_arg_bytes", "log_output_bytes", "while_count",
            "loop_trip_mean", *COLLECTIVE}
    assert set(pf) == held | set(NOT_HELD)
    for name, why in NOT_HELD.items():
        assert np.isfinite(pf[name]) and np.isfinite(jn[name]), name
        record_property(name, f"port {pf[name]:.6g}, jax {jn[name]:.6g} "
                              f"({why})")
