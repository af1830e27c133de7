"""Chrome/Perfetto ``trace_event`` tracing on the virtual clock.

The :class:`Tracer` collects events in the JSON Object Format the
Chrome tracing tools and Perfetto ingest (``{"traceEvents": [...]}``,
https://ui.perfetto.dev): complete spans (``ph: "X"``), begin/end stacks
(``"B"``/``"E"``), instants (``"i"``), counters (``"C"``) and async
spans (``"b"``/``"e"``).  Timestamps are **virtual seconds converted to
microseconds** (``ts = t * 1e6``) — no wall-clock value ever enters a
trace, so a seeded run emits a byte-identical trace on any machine (the
determinism golden in ``tests/test_obs.py`` pins this).

Tracks are named, not numbered: callers pass ``process=``/``thread=``
strings ("replica0" / "steps") and the tracer lazily assigns stable
integer pids/tids in first-use order, emitting the ``"M"``
``process_name`` / ``thread_name`` metadata events Perfetto uses for
labels.

:func:`validate_chrome_trace` is the schema gate the benchmarks and CI
run before a trace file is accepted: per-event field checks plus the
B/E stack-balance invariant per track.

Stdlib only — importable from ``repro_torch.sched.cluster`` without cycles.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

#: phases this tracer emits (a subset of the trace_event spec)
_PHASES = ("X", "B", "E", "i", "C", "b", "e", "M")


class Tracer:
    """Collects ``trace_event`` records; ``chrome()`` / ``dump()`` emit
    the JSON Object Format.  All timestamps are virtual seconds (the
    runtime's clock); the tracer converts to µs."""

    enabled = True

    def __init__(self):
        self.events: List[Dict] = []
        self._pids: Dict[str, int] = {}
        self._tids: Dict[Tuple[str, str], int] = {}
        #: per-track B/E stack (span-nesting invariant enforced live)
        self._stacks: Dict[Tuple[int, int], List[str]] = {}

    # --- track registry ---------------------------------------------------
    def _track(self, process: str, thread: str) -> Tuple[int, int]:
        pid = self._pids.get(process)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[process] = pid
            self.events.append({"ph": "M", "name": "process_name",
                                "pid": pid, "tid": 0,
                                "args": {"name": process}})
        key = (process, thread)
        tid = self._tids.get(key)
        if tid is None:
            tid = sum(1 for p, _ in self._tids if p == process) + 1
            self._tids[key] = tid
            self.events.append({"ph": "M", "name": "thread_name",
                                "pid": pid, "tid": tid,
                                "args": {"name": thread}})
        return pid, self._tids[key]

    @staticmethod
    def _us(t: float) -> float:
        return float(t) * 1e6

    def _emit(self, ev: Dict, args: Optional[Dict]) -> None:
        if args:
            ev["args"] = args
        self.events.append(ev)

    # --- event kinds ------------------------------------------------------
    def complete(self, name: str, t0: float, t1: float, *,
                 process: str = "runtime", thread: str = "main",
                 cat: str = "", args: Optional[Dict] = None) -> None:
        """One complete span (``ph: "X"``) from ``t0`` to ``t1``
        virtual seconds."""
        pid, tid = self._track(process, thread)
        ev = {"ph": "X", "name": name, "ts": self._us(t0),
              "dur": self._us(max(float(t1) - float(t0), 0.0)),
              "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        self._emit(ev, args)

    def begin(self, name: str, t: float, *,
              process: str = "runtime", thread: str = "main",
              args: Optional[Dict] = None) -> None:
        """Open a stack span (``ph: "B"``); must be closed by
        :meth:`end` on the SAME track, innermost first."""
        pid, tid = self._track(process, thread)
        self._stacks.setdefault((pid, tid), []).append(name)
        self._emit({"ph": "B", "name": name, "ts": self._us(t),
                    "pid": pid, "tid": tid}, args)

    def end(self, t: float, *, process: str = "runtime",
            thread: str = "main", name: Optional[str] = None,
            args: Optional[Dict] = None) -> None:
        """Close the innermost open span on the track (``ph: "E"``).
        Passing ``name`` asserts it matches — the nesting invariant."""
        pid, tid = self._track(process, thread)
        stack = self._stacks.get((pid, tid), [])
        if not stack:
            raise ValueError(f"end() with no open span on track "
                             f"{process!r}/{thread!r}")
        top = stack.pop()
        if name is not None and name != top:
            stack.append(top)
            raise ValueError(f"end({name!r}) does not match open span "
                             f"{top!r} on track {process!r}/{thread!r}")
        self._emit({"ph": "E", "name": top, "ts": self._us(t),
                    "pid": pid, "tid": tid}, args)

    def instant(self, name: str, t: float, *,
                process: str = "runtime", thread: str = "main",
                cat: str = "", args: Optional[Dict] = None) -> None:
        pid, tid = self._track(process, thread)
        ev = {"ph": "i", "name": name, "ts": self._us(t), "s": "t",
              "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        self._emit(ev, args)

    def counter(self, name: str, t: float, values: Dict[str, float], *,
                process: str = "runtime") -> None:
        """One sample of a multi-series counter track (``ph: "C"``)."""
        pid, tid = self._track(process, "counters")
        self.events.append({"ph": "C", "name": name, "ts": self._us(t),
                            "pid": pid, "tid": tid,
                            "args": {k: float(v)
                                     for k, v in values.items()}})

    def async_begin(self, name: str, t: float, ident, *, cat: str,
                    process: str = "runtime", thread: str = "main",
                    args: Optional[Dict] = None) -> None:
        """Open an async span (``ph: "b"``) — overlapping lifecycles
        (requests, jobs, transfers) keyed by ``(cat, ident)``."""
        pid, tid = self._track(process, thread)
        self._emit({"ph": "b", "name": name, "ts": self._us(t),
                    "id": str(ident), "cat": cat, "pid": pid,
                    "tid": tid}, args)

    def async_end(self, name: str, t: float, ident, *, cat: str,
                  process: str = "runtime", thread: str = "main",
                  args: Optional[Dict] = None) -> None:
        pid, tid = self._track(process, thread)
        self._emit({"ph": "e", "name": name, "ts": self._us(t),
                    "id": str(ident), "cat": cat, "pid": pid,
                    "tid": tid}, args)

    # --- output -----------------------------------------------------------
    def chrome(self) -> Dict:
        """The JSON Object Format payload Perfetto/chrome://tracing
        open directly."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def dump(self, path: str) -> Dict:
        """Validate, then write the trace to ``path``.  Returns the
        payload (handy for immediate summarizing)."""
        payload = self.chrome()
        validate_chrome_trace(payload)
        with open(path, "w") as f:
            json.dump(payload, f, separators=(",", ":"),
                      sort_keys=True)
        return payload

    def __len__(self) -> int:
        return len(self.events)


class NullTracer:
    """The disabled default: every method is a no-op, so instrumented
    code can call unconditionally.  Hot paths that would build argument
    dicts should still guard on ``tracer.enabled``."""

    enabled = False
    events: List[Dict] = []

    def _noop(self, *a, **k) -> None:
        return None

    complete = begin = end = instant = counter = _noop
    async_begin = async_end = _noop

    def chrome(self) -> Dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def __len__(self) -> int:
        return 0


def validate_chrome_trace(obj) -> None:
    """Raise ``ValueError`` unless ``obj`` is a schema-valid
    ``trace_event`` JSON Object Format payload.

    Checks per event: known phase, non-empty name, integer pid/tid,
    finite non-negative ``ts`` (metadata events excepted), ``dur`` on
    complete spans, ``id``+``cat`` on async events, numeric ``args`` on
    counters — plus the cross-event B/E stack-balance invariant per
    ``(pid, tid)`` track (every begin closed, innermost first)."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    stacks: Dict[Tuple[int, int], List[str]] = {}
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: event must be an object")
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"{where}: unknown phase {ph!r}")
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            raise ValueError(f"{where}: missing/empty name")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                raise ValueError(f"{where}: {k} must be an integer")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts != ts \
                    or ts in (float("inf"), float("-inf")) or ts < 0:
                raise ValueError(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: complete span needs "
                                 f"dur >= 0, got {dur!r}")
        if ph in ("b", "e"):
            if "id" not in ev or not ev.get("cat"):
                raise ValueError(f"{where}: async event needs id + cat")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or any(
                    not isinstance(v, (int, float))
                    for v in args.values()):
                raise ValueError(f"{where}: counter needs numeric args")
        if ph == "M":
            if name not in ("process_name", "thread_name") or \
                    not isinstance(ev.get("args", {}).get("name"), str):
                raise ValueError(f"{where}: bad metadata event")
        if ph == "B":
            stacks.setdefault((ev["pid"], ev["tid"]), []).append(name)
        elif ph == "E":
            stack = stacks.get((ev["pid"], ev["tid"]), [])
            if not stack:
                raise ValueError(f"{where}: E with no open B on track "
                                 f"({ev['pid']}, {ev['tid']})")
            top = stack.pop()
            if top != name:
                raise ValueError(f"{where}: E({name!r}) does not close "
                                 f"B({top!r})")
    open_tracks = {k: v for k, v in stacks.items() if v}
    if open_tracks:
        raise ValueError(f"unclosed B spans at end of trace: "
                         f"{open_tracks}")
