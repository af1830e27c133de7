"""Find the knee of an open-loop serving cell: run its mix at each of
several rates (one process, the cell's own sizes) and print, for each,
how the waiting queue (requests due but not yet joined) grows over the
window.  The knee is the highest rate whose queue does not grow; the
cell's ``rate_per_s`` is set from it by hand.

    python3 chipbench/sweep.py --workload <open-loop cell> \
        --rates 1,2,3,4 --seconds 30 --seed 5
"""
import argparse
import json
import sys

from run import _environment


def queue_at(rec, t: float) -> int:
    return sum(1 for rid, due in rec.due.items()
               if due <= t and rec.joined.get(rid, float("inf")) > t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--serving", default="",
                    help="overrides of the configuration's serving "
                         "settings, e.g. max_batch=8,kv_pool_tokens=16384")
    args = ap.parse_args(argv)
    _environment()
    from chipbench.harness import cells, endtoend, guard, serve
    cell = cells.load(args.workload)
    guard.require_cards(cell.chips)
    for kv in filter(None, args.serving.split(",")):
        k, v = kv.split("=")
        cell.config["serving"][k] = int(v)
    print(json.dumps({"serving": cell.config["serving"]}), flush=True)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell.workload["requests"]["rate_per_s"] = rate
        rec, rd = serve.run(cell, args.seed, args.seconds, False)
        w0, w1 = rec.window
        qs = [queue_at(rec, w0 + f * (w1 - w0)) for f in (0, .25, .5, .75, 1)]
        done = sum(1 for ts in rec.stamps.values() if ts and ts[-1] <= w1)
        row = {"rate": rate, "due": endtoend.attempted(rec),
               "queue_over_window": qs,
               "ttft_p50_s": endtoend.ttft_p50_s(rec),
               "itl_p95_ms": endtoend.itl_p95_ms(rec),
               "requests_with_tokens": done,
               "logit_gap_max": rd["numbers"]["logit_gap_max"]["value"]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
