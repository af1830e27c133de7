"""Readings that the limits of ``correct`` are set from, at a cell's own
sizes, in one process: the program's number on each of many seeds, the
control's (the plain reference in fp8, the precision below the
configuration's bf16) on a few, and for a training cell the planted
faults' (a step that returns its state unchanged; half of each batch
left out).  One JSON line per reading.

    python3 chipbench/calibrate.py --workload qwen3-0.6b.train-16k \
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 5 --faults
"""
import argparse
import gc
import json
import sys

from run import _environment


def _stats(gaps) -> dict:
    """The gaps' summary, over all sampled tokens and request by request
    (the largest over the requests): what a limit could be set on."""
    import torch
    per = [x.double().cpu() for x in gaps]
    g = torch.cat(per)
    at = (0.5, 0.8, 0.9, 0.95, 0.99)
    q = torch.quantile(g, torch.tensor(at, dtype=g.dtype))
    out = {"max": float(g.max()), "mean": float(g.mean()),
           **{f"p{round(100 * a)}": float(v) for a, v in zip(at, q)},
           "tokens": int(g.numel()), "requests": len(per)}
    for tol in (0.0, 0.01, 0.05):
        out[f"share_over_{tol}"] = float((g > tol).double().mean())
    out["request_tokens"] = [int(x.numel()) for x in per]
    out["request_p50"] = [float(torch.quantile(x, 0.5)) for x in per]
    return out


def serve_readings(cell, seeds, control_seeds, seconds):
    """Each seed's program numbers and, on the control seeds, the
    control's, each judged with the cell's limits as a run judges."""
    import torch
    from chipbench import archs
    from chipbench.harness import serve, weights
    from chipbench.reference.compare import judge, serve_numbers
    arch = archs.for_config(cell.config)
    ref = arch.reference
    dm = ref.Dims.of(cell.config)
    limits = cell.workload["check"]["limits"]
    min_tokens = int(cell.workload["check"].get("request_min_tokens", 1))
    for seed in seeds:
        rec, rd = serve.run(cell, seed, seconds, False)
        row = {"seed": seed, "program": _stats(rd["gaps"]),
               "program_correct": judge(rd["numbers"], limits),
               "program_numbers": _values(rd["numbers"])}
        if seed in control_seeds:
            del rec
            gc.collect()
            torch.cuda.empty_cache()
            params = weights.make(arch.model_config(cell.config), seed,
                                  "cuda")
            gaps = ref.served_gaps(params, dm, rd["sample"]["prompts"],
                                   rd["sample"]["served"], "cuda",
                                   quant=True)
            nums = serve_numbers(gaps, min_tokens)
            row["control"] = _stats(gaps)
            row["control_correct"] = judge(nums, limits)
            row["control_numbers"] = _values(nums)
            # one request's tokens altered where produced, as a broken
            # row of the batch would serve them: the longest sampled
            served = [list(x) for x in rd["sample"]["served"]]
            i = max(range(len(served)), key=lambda j: len(served[j]))
            served[i][1:] = [(t + 97) % dm.vocab for t in served[i][1:]]
            one = serve_numbers(ref.served_gaps(
                params, dm, rd["sample"]["prompts"], served, "cuda"),
                min_tokens)
            row["one_request_correct"] = judge(one, limits)
            row["one_request_numbers"] = _values(one)
            del params
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def train_readings(cell, seeds, control_seeds, seconds, faults):
    import torch
    from chipbench import archs
    from chipbench.harness import faults as planted, train, weights
    from chipbench.reference import train as ref_train
    from chipbench.reference.compare import train_numbers
    from chipbench.traffic.train_batches import Batches
    arch = archs.for_config(cell.config)
    ref_mod = arch.reference
    dm = ref_mod.Dims.of(cell.config)
    hp = cell.workload["optimizer"]
    cfg = arch.model_config(cell.config, training=True)
    for seed in seeds:
        _, rd = train.run(cell, seed, seconds, False)
        out = {"seed": seed, "program": _values(rd["numbers"])}
        if faults and seed in control_seeds:
            for name, fault in (("unchanged", planted.unchanged),
                                ("half_batch", planted.half_batch)):
                _, fr = train.run(cell, seed, seconds, False, fault=fault)
                out[name] = _values(fr["numbers"])
        if seed in control_seeds:
            data = Batches(cell.workload["batches"], seed, cfg.vocab_size,
                           "cuda")
            first = [data.next() for _ in range(train.CHECKED_STEPS)]
            ref = ref_train.run(weights.make(cfg, seed, "cuda"), ref_mod,
                                dm, first, hp)
            ctl = ref_train.run(weights.make(cfg, seed, "cuda"), ref_mod,
                                dm, first, hp, quant=True)
            out["control"] = _values(train_numbers(ctl, ref))
        print(json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def _values(numbers):
    return {k: n["value"] for k, n in numbers.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    _environment()
    from chipbench.harness import cells, guard
    cell = cells.load(args.workload)
    guard.require_cards(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    if cell.kind == "serve":
        serve_readings(cell, seeds, ctl, args.seconds)
    else:
        train_readings(cell, seeds, ctl, args.seconds, args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
