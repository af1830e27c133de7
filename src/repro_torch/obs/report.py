"""Rebuild a run's story from its trace alone.

:func:`summarize` reads a Chrome/Perfetto ``trace_event`` JSON file (as
emitted by :class:`~repro_torch.obs.trace.Tracer` through the engine /
simulator / topology hooks) and reconstructs:

* the **time breakdown** — queueing (request routed -> first join),
  prefill, decode, and network transfer seconds;
* **per-node occupancy** — each replica's step-span busy time over the
  run's elapsed virtual time;
* **per-link occupancy** — busy fraction and peak concurrent flows,
  integrated from the ``link:*`` flow counter samples;
* **event rates** — runtime events dispatched per kind (and stale
  drops) per virtual second;
* **goodput and migrations** — finished requests' token sum over
  elapsed time, and completed KV-migration transfers — plus the same
  goodput broken down **per tenant** from the tenant tag on request
  lifecycle spans (tenancy runs).  These reproduce
  the serving bench's numbers from the trace alone (`benchmarks/
  serving_bench.py` asserts bit-equality), which is the acceptance bar
  for the trace being a faithful record rather than a pretty picture.

Used by ``scripts/trace_report.py``; stdlib only.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple


def load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _span_bounds(ev: Dict) -> Tuple[float, float]:
    """(t0, t1) seconds of a complete span — exact when the emitter
    stamped raw seconds into args (the engine's step spans do), the
    µs round-trip otherwise."""
    args = ev.get("args") or {}
    t0 = args.get("t0", ev["ts"] / 1e6)
    t1 = args.get("t1", (ev["ts"] + ev.get("dur", 0.0)) / 1e6)
    return float(t0), float(t1)


def summarize(trace) -> Dict:
    """``trace`` is a path or an already-loaded payload dict."""
    if isinstance(trace, str):
        trace = load(trace)
    events = trace.get("traceEvents", [])

    processes: Dict[int, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            processes[ev["pid"]] = ev["args"]["name"]

    # two elapsed candidates: exact raw-seconds stamps (step/xfer span
    # args, request-end args) and the µs round-trip fallback.  Exact
    # wins when any emitter stamped one — the µs round-trip can drift
    # by ~1e-10 relative, which breaks the bit-identical goodput check.
    elapsed_exact: Optional[float] = None
    elapsed_us = 0.0
    prefill_s = decode_s = 0.0
    transfer_s: Dict[str, float] = {}
    node_busy: Dict[str, float] = {}
    node_steps: Dict[str, int] = {}
    events_by_kind: Dict[str, int] = {}
    stale_by_kind: Dict[str, int] = {}
    req_begin: Dict[str, float] = {}
    req_join: Dict[str, float] = {}
    good_tokens = 0
    completed = 0
    migrations = 0
    # per-tenant goodput, rebuilt from the tenant tag the engine stamps
    # on request lifecycle spans (absent on untenanted runs)
    tenant_tokens: Dict[str, int] = {}
    tenant_completed: Dict[str, int] = {}
    link_samples: Dict[str, List[Tuple[float, float]]] = {}

    for ev in events:
        ph, name = ev.get("ph"), ev.get("name", "")
        if ph == "X":
            t0, t1 = _span_bounds(ev)
            if "t1" in (ev.get("args") or {}):
                elapsed_exact = t1 if elapsed_exact is None \
                    else max(elapsed_exact, t1)
            else:
                elapsed_us = max(elapsed_us, t1)
            proc = processes.get(ev["pid"], str(ev["pid"]))
            if name == "step":
                node_busy[proc] = node_busy.get(proc, 0.0) + (t1 - t0)
                node_steps[proc] = node_steps.get(proc, 0) + 1
            elif name == "prefill":
                prefill_s += t1 - t0
            elif name == "decode":
                decode_s += t1 - t0
            elif name.startswith("xfer:"):
                tag = name[len("xfer:"):]
                transfer_s[tag] = transfer_s.get(tag, 0.0) + (t1 - t0)
                if tag == "kv-migration":
                    migrations += 1
            elif name.startswith("event:"):
                kind = name[len("event:"):]
                events_by_kind[kind] = events_by_kind.get(kind, 0) + 1
        elif ph == "i":
            if name.startswith("stale:"):
                kind = name[len("stale:"):]
                stale_by_kind[kind] = stale_by_kind.get(kind, 0) + 1
            elif name == "join":
                rid = str((ev.get("args") or {}).get("rid"))
                req_join.setdefault(rid, ev["ts"] / 1e6)
        elif ph == "b" and name == "req":
            req_begin.setdefault(ev["id"], ev["ts"] / 1e6)
        elif ph == "e" and name == "req":
            args = ev.get("args") or {}
            good_tokens += int(args.get("tokens", 0))
            completed += 1
            if "tenant" in args:
                tn = str(args["tenant"])
                tenant_tokens[tn] = tenant_tokens.get(tn, 0) \
                    + int(args.get("tokens", 0))
                tenant_completed[tn] = tenant_completed.get(tn, 0) + 1
            if "t1" in args:
                t1 = float(args["t1"])
                elapsed_exact = t1 if elapsed_exact is None \
                    else max(elapsed_exact, t1)
            else:
                elapsed_us = max(elapsed_us, ev["ts"] / 1e6)
        elif ph == "C" and name.startswith("link:"):
            link_samples.setdefault(name[len("link:"):], []).append(
                (ev["ts"] / 1e6, float(ev["args"].get("flows", 0.0))))

    elapsed = elapsed_exact if elapsed_exact is not None else elapsed_us

    # queueing: routed -> first join, per request that ever joined
    queueing = [req_join[r] - t for r, t in req_begin.items()
                if r in req_join]

    per_link: Dict[str, Dict] = {}
    for lname, samples in sorted(link_samples.items()):
        busy = 0.0
        peak = 0.0
        for (t0, flows), (t1, _) in zip(samples, samples[1:]):
            peak = max(peak, flows)
            if flows > 0:
                busy += t1 - t0
        if samples:
            peak = max(peak, samples[-1][1])
            if samples[-1][1] > 0:               # busy through the end
                busy += max(elapsed - samples[-1][0], 0.0)
        per_link[lname] = {
            "busy_s": busy,
            "busy_frac": busy / elapsed if elapsed > 0 else 0.0,
            "peak_flows": int(peak)}

    n_dispatched = sum(events_by_kind.values())
    return {
        "elapsed_s": elapsed,
        "breakdown": {
            "queueing_s": sum(queueing),
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "transfer_s": sum(transfer_s.values()),
        },
        "transfer_by_tag_s": transfer_s,
        "per_node": {
            proc: {"steps": node_steps.get(proc, 0), "busy_s": busy,
                   "occupancy": busy / elapsed if elapsed > 0 else 0.0}
            for proc, busy in sorted(node_busy.items())},
        "per_link": per_link,
        "events_by_kind": events_by_kind,
        "stale_by_kind": stale_by_kind,
        "events_per_virtual_s": n_dispatched / elapsed
        if elapsed > 0 else 0.0,
        "requests": len(req_begin),
        "completed": completed,
        "good_tokens": good_tokens,
        # EXACTLY ServingMetrics.summary's goodput formula, so a traced
        # bench reproduces its goodput bit-identically from the trace
        "goodput_tok_s": good_tokens / max(elapsed, 1e-12),
        "migrations": migrations,
        # per-tenant breakdown, same goodput formula per tenant ({} on
        # untenanted traces)
        "tenants": {
            tn: {"completed": tenant_completed.get(tn, 0),
                 "good_tokens": tenant_tokens.get(tn, 0),
                 "goodput_tok_s": tenant_tokens.get(tn, 0)
                 / max(elapsed, 1e-12)}
            for tn in sorted(tenant_tokens)},
    }


def format_report(rep: Dict, title: Optional[str] = None) -> str:
    b = rep["breakdown"]
    lines = []
    if title:
        lines.append(f"== {title} ==")
    lines.append(
        f"elapsed {rep['elapsed_s']:.3f}s virtual | "
        f"{rep['completed']}/{rep['requests']} requests | goodput "
        f"{rep['goodput_tok_s']:.1f} tok/s | migrations "
        f"{rep['migrations']}")
    lines.append(
        f"breakdown: queueing {b['queueing_s']:.3f}s | prefill "
        f"{b['prefill_s']:.3f}s | decode {b['decode_s']:.3f}s | "
        f"transfer {b['transfer_s']:.3f}s")
    for proc, st in rep["per_node"].items():
        lines.append(f"node {proc}: {st['steps']} steps, busy "
                     f"{st['busy_s']:.3f}s ({st['occupancy']:.1%})")
    for lname, st in rep["per_link"].items():
        lines.append(f"link {lname}: busy {st['busy_frac']:.1%}, peak "
                     f"{st['peak_flows']} flows")
    for tn, st in rep.get("tenants", {}).items():
        lines.append(f"tenant {tn}: {st['completed']} completed, "
                     f"goodput {st['goodput_tok_s']:.1f} tok/s")
    kinds = " ".join(f"{k}:{n}" for k, n in
                     sorted(rep["events_by_kind"].items()))
    stale = sum(rep["stale_by_kind"].values())
    lines.append(f"events [{kinds}] ({rep['events_per_virtual_s']:.0f}"
                 f"/virtual-s, {stale} stale)")
    return "\n".join(lines)
