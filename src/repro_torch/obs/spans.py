"""Spans and work counters for ``torch.profiler`` traces of the port.

* :func:`span` / :func:`spanned` — a profiler range named
  ``<layer>.<part>`` (``serve.decode_call``, ``model.attn``,
  ``moe.experts``, ``train.backward``, ...) around one unit of the
  program's work, opened only while a profiler runs.  Otherwise
  :func:`span` returns the shared no-op :data:`OFF` and a call costs one
  flag check.  The ranges land in the same kineto trace as the device
  operations, so a trace reader can put each kernel down to the range
  that launched it (by the launch's correlation id) and each idle gap
  to the range the host was in.

  The range is function-scoped, as PyTorch's compiled graphs open
  theirs, not a user annotation: kineto copies a user annotation onto
  the device's timeline as well, where it would read as device work.

* :data:`COUNTERS` — the process's work counters
  (:class:`~repro_torch.obs.telemetry.Telemetry`, ``inc()``), counted
  always: what each call computed against what it needed
  (``serve.tokens_computed`` / ``serve.tokens_useful``,
  ``attn.kv_gathered`` / ``attn.kv_live``, ``moe.slots_computed`` /
  ``moe.pairs_routed``).  Every count is a host integer taken from
  shapes or from the backend's host mirrors; none reads the device.

Unlike the rest of ``repro_torch.obs`` (copies of the JAX package's
stdlib-only modules) this module imports torch; the package's
``__init__`` does not import it.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

from repro_torch.obs.telemetry import Telemetry

#: the process's work counters
COUNTERS = Telemetry()

#: what :func:`span` returns while no profiler runs
OFF = contextlib.nullcontext()

_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A profiler range ``name`` while a profiler runs, else :data:`OFF`."""
    if _profiler._is_profiler_enabled:
        return _range(name)
    return OFF


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if _profiler._is_profiler_enabled:
                with _range(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return run
    return wrap
