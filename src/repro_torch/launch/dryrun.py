"""Multi-pod dry-run of the port: every (arch x shape x mesh) cell's step
run once as one rank of the production mesh, on fake tensors.

The counterpart of the JAX package's ``launch/dryrun.py``, with the same
command line, cells and result file:

    python -m repro_torch.launch.dryrun --arch qwen3-14b \
        --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both \
        --out results/dryrun.json

For each cell ``lower_cell`` builds the mesh (``launch/mesh.py::
make_production_mesh``: 16x16 or 2x16x16, a ``fake`` process group in
which this process is rank 0) and the port's sharded step of the cell's
kind: ``train/sharded.py::build_sharded_train_step`` for ``train_4k``,
``train/sharded_serve.py``'s prefill step for ``prefill_32k`` and serve
step for ``decode_32k`` and ``long_500k``, with ``--opts ep_moe`` /
``ep_moe_tp`` running the MoE layers expert-parallel as the JAX dry-run
does.  The parameters, the AdamW state, the batch and the cache are
``device="meta"`` DTensors at the rule tables' placements
(``train_shardings``, ``serve_shardings``, ``batch_specs``), whose local
shards ``utils/step_analyzer.py::analyze`` turns into fake tensors and
runs the step over once: nothing is allocated or launched, no global
tensor is ever made, and the collectives over the fake group move
nothing.  The record (appended to ``--out``, read by
``core/features.py::features_from_record``, ``benchmarks/roofline.py``
and ``core/workloads.py::tpu_jobs_suite``) keeps the JAX record's keys,
each per device (one rank's share), filled with ``StepCost``'s eager
quantities.  Deliberate differences from the JAX record:

* ``cost.flops_per_device``: the matrix products' FLOPs, as the JAX
  analyzer counts ``dot``s; ``cost.xla_flops_raw`` holds the same number
  (no loop body is counted once here, as XLA's ``cost_analysis`` does).
* ``cost.hbm_bytes_per_device`` and ``bytes_by_op``: every eager op's
  input and output bytes, not a fused program's (``xla_bytes_raw``
  holds the same number).
* ``memory.temp_bytes``: the peak of the live storages the step's ops
  make; ``alias_bytes``: the result leaves written in place into their
  arguments (the KV cache), where XLA counts donated buffers;
  ``peak_bytes``: argument + temporary + output bytes less the aliased
  ones, the footprint bound, where XLA reports its allocator's peak.
* ``hlo_ops``: ``dot`` the matrix-product ops, ``fusion`` every eager op
  (a kernel each), ``while`` the loops; ``loops``: the layer stacks and
  declared recurrences (``step_analyzer``).
* ``collectives``: the c10d collectives the rank issues, by JAX's kind
  names, with their operand bytes.
* ``roofline``: the H100's constants (``launch/mesh.py``), ``NVLINK_BW``
  for ``ICI_BW``.
* ``timing.lower_s``: the seconds of building the step and running it on
  fake tensors; ``compile_s`` is 0.0 (nothing compiles).
* The Mamba2 layers compute their H/M heads on each rank
  (``launch/sharding.py::tp_leaves``), as the attention blocks their
  heads; their ``in_proj``, ``conv_w`` and ``conv_b`` are gathered (the
  rule table's column runs cross the packed boundaries) and their
  columns taken on the rank, so those leaves' gathered copies count in
  the temporaries where GSPMD would compute on the stored split.
* ``--only-missing`` skips every cell already in ``--out``, failed ones
  too (the JAX dry-run accepts the flag and retries failed cells);
  without it a cell recorded ``ok`` is skipped and a failed one run
  again, as there.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs import SHAPES, TrainConfig, get_config, input_specs
from repro_torch.configs.registry import all_cells
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     PRODUCTION_MESHES,
                                     make_production_mesh, num_chips)
from repro_torch.models import model as model_lib
from repro_torch.train import optim
from repro_torch.utils.tree import flatten_with_paths


def arch_train_config(arch: str) -> TrainConfig:
    """Per-arch training knobs: the 1T-class arch uses bf16 Adam moments."""
    if arch.startswith("kimi"):
        return TrainConfig(adam_dtype="bfloat16")
    return TrainConfig()


def count_params(cfg, abstract_params) -> Dict[str, float]:
    total = 0
    expert = 0
    for path, leaf in flatten_with_paths(abstract_params):
        n = int(np.prod(leaf.shape))
        total += n
        if any(k in path for k in ("w_gate", "w_up", "w_down")):
            expert += n
    active = total - expert
    if cfg.num_experts:
        active += expert * cfg.experts_per_token / cfg.num_experts
    return {"params_total": float(total), "params_active": float(active)}


def _placed(tree, shardings):
    """``tree``'s meta leaves as meta DTensors at ``shardings``' placements
    (each rank's local shard of the global shape)."""
    from repro_torch.train.sharded import distribute
    from repro_torch.utils.tree import tree_map
    return tree_map(distribute, tree, shardings)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: Optional[Dict[str, Any]] = None,
               opts: Optional[set] = None):
    """Build one cell's sharded step and run it once on fake tensors.
    Returns (record, the ``StepCost``).

    ``opts``: named optimizations measured in EXPERIMENTS.md §Perf —
      ep_moe     expert-parallel MoE dispatch (``moe_ffn_ep``)
      ep_moe_tp  the same, its dispatch split over 'model' too
      (config-level levers go through ``overrides``.)
    """
    from repro_torch.train.sharded import build_sharded_train_step
    from repro_torch.train.sharded_serve import (build_sharded_prefill_step,
                                                 build_sharded_serve_step)
    from repro_torch.utils.step_analyzer import analyze
    opts = opts or set()
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**{k: v for k, v in overrides.items()
                             if hasattr(cfg, k)})
    shape = SHAPES[shape_name]
    specs = input_specs(cfg, shape)
    abstract_params = model_lib.abstract(cfg)
    pcounts = count_params(cfg, abstract_params)
    ep = dict(ep=("ep_moe" in opts or "ep_moe_tp" in opts)
              and cfg.family == "moe", tp_dispatch="ep_moe_tp" in opts)

    t0 = time.time()
    if shape.kind == "train":
        tc = arch_train_config(arch)
        abstract_opt = optim.abstract_opt_state(abstract_params, tc)
        sh = shd.train_shardings(cfg, mesh, abstract_params, abstract_opt,
                                 specs, tc)
        step = build_sharded_train_step(cfg, tc, sh, **ep)
        args = (_placed(abstract_params, sh["params"]),
                _placed(abstract_opt, sh["opt"]),
                _placed(specs, sh["batch"]))
    elif shape.kind == "prefill":
        abstract_cache = model_lib.init_cache(
            cfg, shape.global_batch, shape.seq_len, abstract_only=True)
        sh = shd.serve_shardings(cfg, mesh, abstract_params, abstract_cache,
                                 shape.global_batch)
        step = build_sharded_prefill_step(cfg, shape.seq_len, sh, **ep)
        bs = shd.to_named(shd.batch_specs(specs, mesh), mesh)
        args = (_placed(abstract_params, sh["params"]),
                _placed(specs, bs))
    else:  # decode
        sh = shd.serve_shardings(cfg, mesh, abstract_params, specs["cache"],
                                 shape.global_batch)
        step = build_sharded_serve_step(cfg, sh, **ep)
        args = (_placed(abstract_params, sh["params"]),
                _placed(specs["token"], sh["token"]),
                _placed(specs["cache"], sh["cache"]))
    hc = analyze(step, *args)
    t_lower = time.time() - t0

    chips = num_chips(mesh)
    flops = hc.flops
    hbm_bytes = hc.hbm_bytes
    coll_bytes = hc.total_collective_bytes
    # every quantity is one rank's (the step runs as rank 0 of the mesh)
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": PRODUCTION_MESHES[multi_pod][2],
        "chips": chips,
        "kind": shape.kind,
        "opts": sorted(opts),
        "overrides": dict(overrides or {}),
        "ok": True,
        **pcounts,
        "memory": {
            "argument_bytes": hc.argument_bytes,
            "output_bytes": hc.output_bytes,
            "temp_bytes": hc.peak_temp_bytes,
            "alias_bytes": hc.alias_bytes,
            "peak_bytes": hc.argument_bytes + hc.peak_temp_bytes
            + hc.output_bytes - hc.alias_bytes,
        },
        "cost": {
            "flops_per_device": flops,
            "hbm_bytes_per_device": hbm_bytes,
            "xla_flops_raw": flops,
            "xla_bytes_raw": hbm_bytes,
        },
        "collectives": {
            "bytes": hc.collective_bytes,
            "counts": hc.collective_counts,
            "total_bytes": coll_bytes,
        },
        "bytes_by_op": {k: v for k, v in sorted(
            hc.bytes_by_op.items(), key=lambda kv: -kv[1])[:10]},
        "loops": hc.loops,
        "hlo_ops": {"dot": hc.matmul_count, "fusion": hc.op_count,
                    "while": len(hc.loops)},
        "roofline": {
            "compute_s": flops / PEAK_FLOPS_BF16,
            "memory_s": hbm_bytes / HBM_BW,
            "collective_s": coll_bytes / NVLINK_BW,
        },
        "timing": {"lower_s": round(t_lower, 2), "compile_s": 0.0},
        "tokens": SHAPES[shape_name].global_batch * (
            SHAPES[shape_name].seq_len if shape.kind == "train" else 1),
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: record["roofline"][k])
    record["roofline"]["dominant"] = dom
    return record, hc


def run_cell_safe(arch, shape_name, multi_pod, overrides=None, opts=None):
    try:
        rec, _ = lower_cell(arch, shape_name, multi_pod, overrides, opts)
        return rec
    except Exception as e:  # noqa: BLE001
        return {"arch": arch, "shape": shape_name,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "ok": False, "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def load_results(path: str) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(path: str, results: Dict[str, Any]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)


def cell_key(arch, shape, multi_pod):
    return f"{arch}|{shape}|{'multi' if multi_pod else 'single'}"


def main(argv=None) -> Dict[str, Any]:
    """The command line; returns the results file's records."""
    import torch.distributed as dist
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells already in --out")
    ap.add_argument("--only-missing", action="store_true",
                    help="skip every cell already in --out, failed too")
    ap.add_argument("--opts", default="",
                    help="comma-separated optimizations (e.g. ep_moe)")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (repeatable)")
    args = ap.parse_args(argv)

    opts = set(o for o in args.opts.split(",") if o)
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = all_cells()
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    results = load_results(args.out)
    try:
        for arch, shape in cells:
            for mp in meshes:
                key = cell_key(arch, shape, mp)
                if key in results and not args.force and (
                        results[key].get("ok") or args.only_missing):
                    print(f"skip {key} (cached)")
                    continue
                print(f"=== {key} ===", flush=True)
                rec = run_cell_safe(arch, shape, mp, overrides or None,
                                    opts or None)
                results[key] = rec
                save_results(args.out, results)
                if rec["ok"]:
                    r = rec["roofline"]
                    print(f"  ok: compute={r['compute_s']:.4f}s "
                          f"memory={r['memory_s']:.4f}s "
                          f"collective={r['collective_s']:.4f}s "
                          f"dominant={r['dominant']} peak="
                          f"{rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
                          f"(analyze {rec['timing']['lower_s']}s)",
                          flush=True)
                else:
                    print(f"  FAIL: {rec['error']}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells ok -> {args.out}")
    return results


if __name__ == "__main__":
    main()
