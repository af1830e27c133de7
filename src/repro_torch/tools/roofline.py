"""Roofline table from the port's dry-run records: three terms per (arch x
shape x mesh), the dominant bottleneck, and MODEL_FLOPS over the step's
counted FLOPs.

    python -m repro_torch.tools.roofline [--dryrun results/dryrun.json]

The roofline fraction is the useful compute's time at the H100's bf16
peak (``launch/mesh.py::PEAK_FLOPS_BF16``) over the step's bound, the
largest of the record's compute, memory and collective terms.  Prints
``SKIPPED`` when no records exist.  Arithmetic on records only: no
device.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.launch.mesh import PEAK_FLOPS_BF16
from repro_torch.tools.common import (DRYRUN_JSON, emit, load_dryrun,
                                      save_result)


def model_flops(rec) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N_active*D for
    inference steps — GLOBAL flops for the cell's token count.

    Token count comes from the shape cell: train/prefill process B x S
    tokens per step; decode processes B (one new token per sequence)."""
    from repro_torch.configs import SHAPES
    shape = SHAPES[rec["shape"]]
    if rec["kind"] in ("train", "prefill"):
        d = shape.global_batch * shape.seq_len
    else:
        d = shape.global_batch
    n = rec["params_active"]
    mult = 6.0 if rec["kind"] == "train" else 2.0
    return mult * n * d


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", default=DRYRUN_JSON,
                    help="the port's dry-run records (repro_torch.launch."
                         "dryrun --out)")
    args = ap.parse_args(argv)
    res = load_dryrun(args.dryrun)
    if not res:
        print("roofline,SKIPPED,no dryrun json (run repro_torch.launch."
              "dryrun)")
        return {}
    payload = {}
    rows = []
    for key, rec in sorted(res.items()):
        if not rec.get("ok"):
            continue
        r = rec["roofline"]
        step_bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
        mf = model_flops(rec)
        hlo_global = rec["cost"]["flops_per_device"] * rec["chips"]
        useful = mf / max(hlo_global, 1e-9)
        # roofline fraction: useful-compute time over the bound step time
        ideal_s = mf / (rec["chips"] * PEAK_FLOPS_BF16)
        frac = ideal_s / max(step_bound, 1e-12)
        payload[key] = {
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "dominant": r["dominant"],
            "model_flops": mf, "hlo_flops_global": hlo_global,
            "useful_flops_ratio": useful,
            "roofline_fraction": frac,
        }
        rows.append((key, frac, r["dominant"]))
        emit(f"roofline_{key}", round(frac, 4),
             f"dom={r['dominant']};c={r['compute_s']:.3g}s;"
             f"m={r['memory_s']:.3g}s;n={r['collective_s']:.3g}s;"
             f"useful={useful:.2f}")
    fracs = [f for _, f, _ in rows]
    doms = [d for _, _, d in rows]
    payload["summary"] = {
        "cells": len(rows),
        "median_fraction": float(np.median(fracs)),
        "worst": min(rows, key=lambda x: x[1])[0] if rows else None,
        "best": max(rows, key=lambda x: x[1])[0] if rows else None,
        "dominant_histogram": {d: doms.count(d) for d in set(doms)},
    }
    emit("roofline_median_fraction",
         round(payload["summary"]["median_fraction"], 4))
    emit("roofline_dominant_hist",
         str(payload["summary"]["dominant_histogram"]).replace(",", ";"))
    save_result("roofline", payload)
    return payload


if __name__ == "__main__":
    main()
