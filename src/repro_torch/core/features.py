"""Runtime feature extraction from a fake-tensor probe of the port's step.

The paper extracts 22 perf-counter features (L1 miss rates, context
switches, IPC, ...) from a ~100 MB profiling run.  The JAX package takes
the equivalent observables from the compiler (``cost_analysis`` /
``memory_analysis`` / its loop-aware HLO analysis of a job's step at a
small probe shape).  The port runs the same probe step once on fake
tensors (``utils/step_analyzer.py``): deterministic, allocation-free,
nothing launched, and available before the job runs.

``extract_features`` returns the same 22-dim vector format the
spark-sim suite uses, so the MoE predictor pipeline (scaler -> PCA ->
KNN) is shared verbatim between universes.  ``TPU_FEATURE_NAMES``,
``_safe_log`` and ``features_from_record`` are the JAX package's,
verbatim.

Deliberate differences from the JAX package's vector (its definitions
are XLA's; the port's are ``step_analyzer.StepCost``'s):

* ``log_flops`` and ``flops_per_token``: matrix-product FLOPs, as JAX's
  dot-only count; equal on dense and MoE steps.  The Mamba2 SSD's
  three-operand einsum contracts in another order than XLA's, which
  differs by 2·B·c·h·p·n per layer (under 0.1% at the probe).
* ``log_hbm_bytes``, ``arithmetic_intensity``, ``bytes_per_token`` and the
  roofline shares: the bytes every eager op reads and writes, more than
  XLA's fused program moves (eager PyTorch runs each op as a kernel).
* ``log_temp_bytes`` and ``temp_to_arg_ratio``: the peak of the live
  storages the step's ops make (eager lifetimes), not XLA's buffer
  assignment.
* ``log_output_bytes``: the result leaves' bytes, without XLA's 8 B per
  leaf of tuple index table.
* ``dot_count``: matrix-product ops; ``fusion_count``: every non-view op
  (each a kernel in eager PyTorch).  ``while_count`` and
  ``loop_trip_mean`` count the same loops as XLA's (the layer stacks,
  the SSD's chunk recurrence, again in the backward and under remat;
  ``step_analyzer``'s ``loops``).
* The roofline terms use the H100's constants (``launch/mesh.py``:
  ``PEAK_FLOPS_BF16``, ``HBM_BW``, and ``NVLINK_BW`` where JAX reads the
  TPU's ``ICI_BW``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

TPU_FEATURE_NAMES: List[str] = [
    "log_flops", "log_hbm_bytes", "arithmetic_intensity",
    "log_collective_bytes", "coll_allreduce_frac", "coll_allgather_frac",
    "coll_alltoall_frac", "coll_permute_frac", "coll_op_count",
    "log_param_bytes", "log_arg_bytes", "log_temp_bytes",
    "temp_to_arg_ratio", "log_output_bytes", "dot_count", "fusion_count",
    "while_count", "loop_trip_mean", "flops_per_token", "bytes_per_token",
    "compute_term_share", "memory_term_share",
]


def _safe_log(x: float) -> float:
    return float(np.log10(max(float(x), 1.0)))


def features_from_record(rec: Dict) -> np.ndarray:
    """22 features from a dry-run record (see launch/dryrun.lower_cell)."""
    rl = rec["roofline"]
    cost = rec["cost"]
    mem = rec["memory"]
    coll = rec["collectives"]
    flops = cost["flops_per_device"]
    hbm = cost.get("hbm_bytes_per_device", cost.get("bytes_per_device", 0))
    cb = coll.get("total_bytes", 0.0)
    by_kind = coll.get("bytes", {})
    counts = coll.get("counts", {})
    ops = rec.get("hlo_ops", {})
    loops = rec.get("loops", [])
    toks = max(rec.get("tokens", 1), 1)
    tot = max(rl["compute_s"] + rl["memory_s"] + rl["collective_s"], 1e-12)

    def frac(kind):
        return float(by_kind.get(kind, 0.0)) / max(cb, 1.0)

    vec = [
        _safe_log(flops),
        _safe_log(hbm),
        float(flops / max(hbm, 1.0)),
        _safe_log(cb),
        frac("all-reduce"),
        frac("all-gather"),
        frac("all-to-all"),
        frac("collective-permute"),
        _safe_log(sum(counts.values()) if counts else 0),
        _safe_log(rec.get("params_total", 0) * 2),
        _safe_log(mem["argument_bytes"]),
        _safe_log(mem["temp_bytes"]),
        float(mem["temp_bytes"] / max(mem["argument_bytes"], 1.0)),
        _safe_log(mem["output_bytes"]),
        _safe_log(ops.get("dot", 0)),
        _safe_log(ops.get("fusion", 0)),
        float(ops.get("while", len(loops))),
        float(np.mean([l["trip"] for l in loops]) if loops else 0.0),
        _safe_log(flops / toks),
        _safe_log(hbm / toks),
        float(rl["compute_s"] / tot),
        float(rl["memory_s"] / tot),
    ]
    assert len(vec) == len(TPU_FEATURE_NAMES)
    return np.asarray(vec, float)


def probe_record(cfg, shape_kind: str = "train", probe_seq: int = 64,
                 probe_batch: int = 2) -> Dict:
    """The record ``features_from_record`` reads (the JAX dry-run
    record's keys, and the ``StepCost`` itself under ``"step_cost"``) of
    the job's step at a probe shape: the train step (params, AdamW
    state, batch) or the serve step (params, token, a ``probe_seq``-slot
    cache).

    Nothing is computed, allocated or launched on any device: the
    parameters come from ``model.abstract``, the inputs from
    ``input_specs`` (``device="meta"``), and ``step_analyzer.analyze``
    runs the step once on fake CPU tensors of their shapes."""
    from repro_torch.configs import input_specs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
    from repro_torch.models import model as model_lib
    from repro_torch.train import optim
    from repro_torch.train.step import build_serve_step, build_train_step
    from repro_torch.utils.step_analyzer import analyze
    from repro_torch.utils.tree import tree_leaves

    shape = ShapeConfig("probe", shape_kind, probe_seq, probe_batch)
    specs = input_specs(cfg, shape)
    abstract_params = model_lib.abstract(cfg)
    if shape_kind == "train":
        tc = TrainConfig()
        step = build_train_step(cfg, tc)
        abstract_opt = optim.abstract_opt_state(abstract_params, tc)
        hc = analyze(step, abstract_params, abstract_opt, specs)
        tokens = probe_batch * probe_seq
    else:
        step = build_serve_step(cfg)
        hc = analyze(step, abstract_params, specs["token"], specs["cache"])
        tokens = probe_batch
    rec = {
        "roofline": {
            "compute_s": hc.flops / PEAK_FLOPS_BF16,
            "memory_s": hc.hbm_bytes / HBM_BW,
            "collective_s": hc.total_collective_bytes / NVLINK_BW,
        },
        "cost": {"flops_per_device": hc.flops,
                 "hbm_bytes_per_device": hc.hbm_bytes},
        "memory": {"argument_bytes": hc.argument_bytes,
                   "temp_bytes": hc.peak_temp_bytes,
                   "output_bytes": hc.output_bytes},
        "collectives": {"total_bytes": hc.total_collective_bytes,
                        "bytes": hc.collective_bytes,
                        "counts": hc.collective_counts},
        "hlo_ops": {"dot": hc.matmul_count, "fusion": hc.op_count,
                    "while": len(hc.loops)},
        "loops": hc.loops,
        "params_total": sum(x.numel() for x in tree_leaves(abstract_params)),
        "tokens": tokens,
        "step_cost": hc,
    }
    return rec


def extract_features(cfg, shape_kind: str = "train", probe_seq: int = 64,
                     probe_batch: int = 2) -> np.ndarray:
    """Probe the job's step at a small shape on fake tensors and extract
    the 22 features (the 100MB-profiling-run analogue)."""
    return features_from_record(probe_record(cfg, shape_kind, probe_seq,
                                             probe_batch))
