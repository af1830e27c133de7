"""Run one cell as ``run.py --trace 1`` does, then print one more JSON
line after its result: the profiled slice by the program's own ranges
(``harness/spans.py``), the span quantities read from it, and the model
calls' wall ms inside the slice against outside it (what tracing costs
while it is on).

    python3 chipbench/trace_spans.py --workload <cell> --seed <n> \
        --seconds 51

The runner's record keeps the slice's summary, not its events: this
script gives the runner a ``Slice`` that reads the events by program
range before it summarises them, and keeps the record it hands to the
metric readers.  Against a program that opens no ranges it prints the
harness's labels alone.
"""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chipbench import run  # noqa: E402

#: the span quantities of each kind of cell
QUANTITIES = {"serve": ("prefill_attn_ms", "decode_idle_ms"),
              "train": ("backward_ms", "optimizer_ms")}


def _tail(events, n=4):
    """The slice's last device operations: name, start and end in ms
    after the slice's host range ended."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    from chipbench.harness.profiling import SLICE, _ns
    end = max(_ns(e, "start") + _ns(e, "duration") for e in events
              if e.name() == SLICE and e.device_type() != cuda)
    dev = sorted((_ns(e, "start") + _ns(e, "duration"), _ns(e, "start"),
                  e.name()) for e in events
                 if e.device_type() == cuda and not e.is_user_annotation())
    return [[name[:60], (s - end) / 1e6, (t - end) / 1e6]
            for t, s, name in dev[-n:]]


def main(argv=None) -> int:
    args = run.parse(argv)
    run._environment()
    from chipbench.harness import cells, profiling, spans
    from chipbench.harness.record import ServeRecord
    from chipbench.metrics.common import call_ms, mean

    kept = {}

    class KeepingSlice(profiling.Slice):
        def summary(self):
            events = self.prof.profiler.kineto_results.events()
            kept["spans"] = spans.read(events)
            kept["tail"] = _tail(events)
            return profiling.summarise(events)

    def metrics_of(cell, record, readings, trace, _read=run.metrics_of):
        kept["record"] = record
        return _read(cell, record, readings, trace)

    profiling.Slice = KeepingSlice
    run.metrics_of = metrics_of
    run.T_START = T_START
    argv = list(argv or sys.argv[1:])
    if "--trace" in argv:
        del argv[argv.index("--trace"):argv.index("--trace") + 2]
    rc = run.main(argv + ["--trace", "1"])
    sp, rec = kept.get("spans"), kept.get("record")
    if rc != 0 or sp is None:
        return rc or 1
    kind = cells.load(args.workload).kind
    out = {"attributed": sp.attributed, "device_s": sp.device_s,
           "unmatched_s": sp.unmatched_s,
           "quantities": {q: spans.METRICS[q](sp) for q in QUANTITIES[kind]},
           "device_by_range": sp.innermost()[:16],
           "idle_by_range": sp.innermost(idle=True)[:16],
           "ranges": sp.count, "tail": kept.get("tail")}
    if isinstance(rec, ServeRecord):
        for k in ("prefill", "decode"):
            inside = rec.calls_in(k, profiled=True)
            out[f"{k}_call_ms"] = {
                "outside": call_ms(rec, k),
                "inside": mean(1e3 * (c.t1 - c.t0) for c in inside),
                "inside_n": len(inside)}
        harness = sp.idle("chipbench/decode_call")
        out["decode_idle_program_share"] = (
            sp.idle("chipbench/decode_call", "serve.decode_call") / harness
            if harness > 0 else None)
    print("spans " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
