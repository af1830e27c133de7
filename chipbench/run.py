"""Run one cell of the benchmark once and print its result.

    python3 chipbench/run.py --workload qwen3-0.6b.train-16k --seed 7 \
        --seconds 51 --trace 0

From the root of a checkout.  The cell is found by name in
``BENCHMARK.json``; its configuration, workload and metric readers are
files under ``chipbench/``.  Set-up (weights from the seed, the kernels'
build under ``build/``, every shape the window uses) runs first, then a
window of ``--seconds`` on the wall clock, then the check of what the
window produced against the plain reference.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
profiled slice of the window.  The last line of standard output is the
result as one JSON object; the numbers compared, each with its limit,
are the last lines of standard error and the result's last key.  Exits
non-zero and prints no result without the cards the cell asks for, or
with JAX or the JAX package loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Import paths, and the program's kernel caches at fixed paths
    inside the checkout."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_of(cell, record, readings, trace: bool) -> dict:
    from chipbench.harness import endtoend
    from chipbench.metrics import reader
    out = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m["name"])(record)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out
    for m in cell.end_to_end:
        v = (readings["setup_s"] if m["name"] == "setup_s"
             else endtoend.METRICS[m["name"]](record))
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    from chipbench.harness import cells, guard
    cell = cells.load(args.workload)
    guard.require_cards(cell.chips)
    import torch
    from chipbench.harness import endtoend
    from chipbench.reference.compare import judge
    from chipbench.roofline.peaks import power_limit
    if cell.kind == "serve":
        from chipbench.harness import serve as runner
    else:
        from chipbench.harness import train as runner
    record, readings = runner.run(cell, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    guard.require_clean()
    numbers = readings["numbers"]
    correct = judge(numbers, cell.workload["check"]["limits"])
    result = {
        "correct": bool(correct),
        "attempted": endtoend.attempted(record),
        "failed": 0,
        "metrics": metrics_of(cell, record, readings, bool(args.trace)),
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips,
                   "memory_peak_bytes": int(readings["memory_peak_bytes"])},
    }
    if args.trace and record.profile is not None:
        p = record.profile
        result["device"].update(busy_s=p.busy_s, window_s=p.window_s)
        result["breakdown"] = {"device_ops": p.device_ops,
                               "idle_gaps": p.idle_gaps}
    compared = {k: n for k, n in numbers.items() if "limit" in n}
    result["compared"] = {k: {"value": n["value"], "limit": n["limit"]}
                          for k, n in compared.items()}
    print(f"chipbench: card {power_limit()}; peaks 989 TFLOP/s bf16, "
          f"3.35 TB/s", file=sys.stderr)
    for k, n in numbers.items():
        if k not in compared:
            print(f"chipbench: recorded, not compared: {k} {n}",
                  file=sys.stderr)
    for k, n in compared.items():
        extra = {x: n[x] for x in n if x not in ("value", "limit")}
        print(f"compared {k} {n['value']!r} limit {n['limit']!r}"
              + (f" {extra}" if extra else ""), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
