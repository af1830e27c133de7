"""Vector-resource budgets for admission control.

The paper's co-location scheme reasons about memory *and* CPU jointly
(Sections 2.2/6.8), and the TPU-fleet adaptation adds device HBM and
interconnect on top of host RAM. This module gives the scheduler a small
algebra over named resource axes so admission can invert the demand
curve along the *binding* axis (the axis whose budget runs out first)
instead of treating memory as the only first-class resource:

* :class:`ResourceVector` — an immutable point in resource space over
  the named axes ``host_ram`` / ``cpu`` / ``hbm`` / ``net``, with
  ``+``/``-``/scalar ``*`` algebra, ``fits`` (componentwise admission
  test) and ``headroom`` (remaining capacity).  Axis *presence* is
  meaningful: an axis absent from a budget vector is unconstrained,
  an axis absent from a demand vector demands nothing.
* :class:`DemandModel` — per-axis demand as a function of admitted work
  units: monotone curves (the calibrated
  :class:`~repro_torch.core.experts.MemoryFunction` for memory-like axes) plus
  per-placement constants (an executor's average CPU load does not scale
  with its input split).  ``inverse(budget)`` returns the largest unit
  count that fits every budgeted axis and *which axis bound it*.

Curves are duck-typed (``fn(x) -> amount``, ``fn.inverse(amount) -> x``)
so this module has no import-time dependency on ``repro_torch.core`` — it can
be loaded first without creating an import cycle.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

if TYPE_CHECKING:  # duck-typed at runtime (anything callable w/ .inverse)
    from repro_torch.core.experts import MemoryFunction

#: The recognised resource axes.  ``host_ram`` is the paper's budget
#: (executor heap vs free host memory); ``cpu`` is the co-location slack
#: check of Section 6.8; ``hbm``/``net`` are the TPU-fleet extensions
#: (device memory, interconnect bandwidth).
AXES = ("host_ram", "cpu", "hbm", "net")

#: Axes shaded by the scheduler's memory-risk rules (safety margin,
#: conservative fallback, OOM backoff).  CPU slack and link bandwidth
#: are average-rate resources — transient overshoot time-shares instead
#: of OOM-killing — so they are offered unshaded.
MEMORY_AXES = ("host_ram", "hbm")


class ResourceVector:
    """An immutable, sparse point in resource space.

    Only the axes passed to the constructor are *present*; algebra
    treats absent axes as zero, while :meth:`fits` treats axes absent
    from the **budget** as unconstrained.
    """

    __slots__ = ("_v",)

    def __init__(self, **axes: float):
        for a in axes:
            if a not in AXES:
                raise ValueError(
                    f"unknown resource axis {a!r} (known: {AXES})")
        object.__setattr__(self, "_v",
                           {a: float(v) for a, v in axes.items()})

    def __setattr__(self, *a):  # immutability guard
        raise AttributeError("ResourceVector is immutable")

    # --- mapping-ish access ---------------------------------------------
    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(self._v)

    def get(self, axis: str, default: float = 0.0) -> float:
        return self._v.get(axis, default)

    def __getitem__(self, axis: str) -> float:
        return self._v[axis]

    def __contains__(self, axis: str) -> bool:
        return axis in self._v

    def __iter__(self) -> Iterator[str]:
        return iter(self._v)

    def items(self):
        return self._v.items()

    def as_dict(self) -> Dict[str, float]:
        return dict(self._v)

    # --- algebra ---------------------------------------------------------
    def _merge(self, other: "ResourceVector", sign: float
               ) -> "ResourceVector":
        axes = dict(self._v)
        for a, v in other._v.items():
            axes[a] = axes.get(a, 0.0) + sign * v
        return ResourceVector(**axes)

    def __add__(self, other: "ResourceVector") -> "ResourceVector":
        return self._merge(other, 1.0)

    def __sub__(self, other: "ResourceVector") -> "ResourceVector":
        return self._merge(other, -1.0)

    def __mul__(self, k: float) -> "ResourceVector":
        return ResourceVector(**{a: v * float(k)
                                 for a, v in self._v.items()})

    __rmul__ = __mul__

    def __eq__(self, other) -> bool:
        return isinstance(other, ResourceVector) and self._v == other._v

    def __hash__(self):
        return hash(tuple(sorted(self._v.items())))

    def __repr__(self) -> str:
        inner = ", ".join(f"{a}={v:g}" for a, v in self._v.items())
        return f"ResourceVector({inner})"

    # --- admission tests --------------------------------------------------
    def fits(self, budget: "ResourceVector", eps: float = 1e-9) -> bool:
        """Componentwise ``demand <= budget``.  Axes the budget does not
        carry are unconstrained; axes this vector does not carry demand
        nothing."""
        return all(v <= budget._v[a] + eps
                   for a, v in self._v.items() if a in budget._v)

    def headroom(self, used: "ResourceVector") -> "ResourceVector":
        """Remaining capacity per *budgeted* axis (may be negative when
        over-committed).  Axes ``used`` carries but this vector does not
        are ignored — they were never constrained."""
        return ResourceVector(**{a: v - used._v.get(a, 0.0)
                                 for a, v in self._v.items()})


def single_axis(axis: str, value: float) -> ResourceVector:
    """The scalar shim's budget: one constrained axis, all others free."""
    return ResourceVector(**{axis: value})


class DemandModel:
    """Per-axis demand as a function of admitted work units.

    ``curves`` maps axes to monotone unit->amount functions (the
    calibrated memory function on the *primary* axis, plus optional
    side-car curves, e.g. host staging RAM for an HBM-resident job);
    ``fixed`` maps axes to per-placement constants that do not scale
    with the unit count (an executor's average CPU load).
    """

    __slots__ = ("primary_axis", "curves", "fixed")

    def __init__(self, curves: Mapping[str, "MemoryFunction"],
                 fixed: Optional[Mapping[str, float]] = None,
                 primary_axis: str = "host_ram"):
        for a in curves:
            if a not in AXES:
                raise ValueError(f"unknown demand axis {a!r}")
        for a in (fixed or {}):
            if a not in AXES:
                raise ValueError(f"unknown demand axis {a!r}")
        # primary first so inverse() tie-breaks toward the primary axis
        ordered = {}
        if primary_axis in curves:
            ordered[primary_axis] = curves[primary_axis]
        ordered.update(curves)
        self.curves = ordered
        self.fixed = {a: float(v) for a, v in (fixed or {}).items()}
        self.primary_axis = primary_axis

    @classmethod
    def scalar(cls, fn: "MemoryFunction", axis: str = "host_ram",
               cpu_load: Optional[float] = None) -> "DemandModel":
        """The back-compat shim: one calibrated curve on one axis (plus
        an optional fixed CPU load)."""
        fixed = {} if cpu_load is None else {"cpu": cpu_load}
        return cls({axis: fn}, fixed, primary_axis=axis)

    @classmethod
    def from_model_config(cls, cfg, max_len: int, *,
                          host_ram_per_req_gb: float = 0.0,
                          refit: bool = False) -> "DemandModel":
        """DEPRECATED shim over the ``kv-growth`` estimator (which now
        owns the per-``(config, max_len)`` calibration cache) — kept
        bit-identical for existing callers.  Prefer::

            get_estimator("kv-growth").estimate(
                ModelTarget(cfg, max_len, ...)).model
        """
        import warnings
        warnings.warn(
            "DemandModel.from_model_config is deprecated; use "
            "repro_torch.sched.estimator.get_estimator('kv-growth')"
            ".estimate(ModelTarget(cfg, max_len, ...)) instead",
            DeprecationWarning, stacklevel=2)
        # runtime-only import: this module must stay loadable before
        # repro_torch.core (see module docstring)
        from repro_torch.sched.estimator import KVGrowthEstimator, ModelTarget
        est = KVGrowthEstimator(refit=refit)
        target = ModelTarget(cfg, int(max_len),
                             host_ram_per_req_gb=host_ram_per_req_gb)
        return est.estimate(target).model

    @property
    def primary_fn(self) -> Optional["MemoryFunction"]:
        return self.curves.get(self.primary_axis)

    def demand(self, units: float) -> ResourceVector:
        """Total per-axis demand of a placement processing ``units``."""
        axes: Dict[str, float] = {a: float(fn(units))
                                  for a, fn in self.curves.items()}
        for a, v in self.fixed.items():
            axes[a] = axes.get(a, 0.0) + v
        return ResourceVector(**axes)

    def inverse(self, budget: ResourceVector
                ) -> Tuple[float, Optional[str]]:
        """Largest ``units`` whose demand fits ``budget``, and the axis
        that bound it (min over per-axis curve inverses).

        Fixed demands gate: if a fixed demand exceeds its budgeted axis,
        nothing fits (0 units, that axis binding).  Curve axes the
        budget does not carry are unconstrained.  Returns ``inf`` with
        ``None`` binding when no budgeted axis constrains the demand.
        """
        for a, v in self.fixed.items():
            if a in budget and v > budget[a]:
                return 0.0, a
        units, binding = np.inf, None
        for a, fn in self.curves.items():
            if a not in budget:
                continue
            # fixed overhead sharing an axis with a curve shrinks the
            # curve's budget on that axis
            x = float(fn.inverse(budget[a] - self.fixed.get(a, 0.0)))
            if x < units:
                units, binding = x, a
        return units, binding
