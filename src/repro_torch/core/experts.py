"""Memory-function experts (paper Table 1) + pluggable extensions.

Each expert is a 2-parameter family y = f_family(x; m, b) modeling an
application's memory footprint y as a function of input size x:

  power           y = m * x^b          (paper: "(piecewise) linear")
  exp_saturation  y = m * (1 - e^{-b x})
  log             y = m + b * ln(x)    (Napierian logarithmic)
  affine          y = m + b * x        [extension: SSM decode state is
                                        O(1) in KV length; weight-dominated
                                        footprints are constant + linear]

The paper's framework is explicitly designed for new experts to be added
(Section 1); `affine` is registered the same way a user would add one.

Calibration is the paper's two-point scheme: profile at 5% and 10% of the
input, solve (m, b) exactly. ``fit`` is the offline least-squares used
when learning which family describes a training program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

FAMILIES = ("power", "exp_saturation", "log", "affine")
PAPER_FAMILIES = ("power", "exp_saturation", "log")


def predict(family: str, m: float, b: float, x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if family == "power":
        return m * np.power(np.maximum(x, 1e-12), b)
    if family == "exp_saturation":
        return m * (1.0 - np.exp(-b * x))
    if family == "log":
        return m + b * np.log(np.maximum(x, 1e-12))
    if family == "affine":
        return m + b * x
    raise ValueError(f"unknown family {family!r}")


@dataclass(frozen=True)
class MemoryFunction:
    family: str
    m: float
    b: float

    def __call__(self, x):
        return predict(self.family, self.m, self.b, x)

    def inverse(self, y: float, x_hint: float = 1.0) -> float:
        """Largest x with f(x) <= y (items an executor can take under a
        memory budget). Monotone families -> closed forms / bisection."""
        m, b = self.m, self.b
        if self.family == "power":
            if m <= 0 or b == 0:
                return np.inf if predict("power", m, b, 1.0) <= y else 0.0
            base = y / m
            if base <= 0:
                return 0.0
            # log-space: base**(1/b) overflows float pow for near-flat
            # fits (tiny b), e.g. a power calibration of an almost-
            # constant footprint — saturate to inf (unbounded; callers
            # cap by chunk/unassigned)
            with np.errstate(over="ignore"):
                x = float(np.exp(np.log(base) / b)) * (1 - 1e-9)
            if not np.isfinite(x):
                return np.inf
            return x if x >= 1e-12 else 0.0  # below predict()'s x-clamp
        if self.family == "exp_saturation":
            if y >= m:  # saturates below budget -> unbounded
                return np.inf
            if y <= 0 or b <= 0:
                return 0.0
            return float(-np.log(1.0 - y / m) / b)
        if self.family == "log":
            if b <= 0:
                return np.inf if m <= y else 0.0
            # a budget far above the curve (e.g. a 4 TB HBM axis against
            # a tens-of-GB log curve) overflows exp — that IS unbounded
            with np.errstate(over="ignore"):
                x = float(np.exp((y - m) / b))
            return x if x >= 1e-12 else 0.0
        if self.family == "affine":
            if b <= 0:
                return np.inf if m <= y else 0.0
            return float(max((y - m) / b, 0.0))
        raise ValueError(self.family)


# ---------------------------------------------------------------------------
# Two-point calibration (the runtime path: 5% and 10% probes)
# ---------------------------------------------------------------------------

def calibrate_two_point(family: str, x1: float, y1: float,
                        x2: float, y2: float) -> MemoryFunction:
    assert 0 < x1 < x2, (x1, x2)
    y1 = max(float(y1), 1e-9)
    y2 = max(float(y2), y1 * (1 + 1e-9))
    if family == "power":
        b = np.log(y2 / y1) / np.log(x2 / x1)
        m = y1 / (x1 ** b)
        return MemoryFunction("power", float(m), float(b))
    if family == "log":
        b = (y2 - y1) / np.log(x2 / x1)
        m = y1 - b * np.log(x1)
        return MemoryFunction("log", float(m), float(b))
    if family == "affine":
        b = (y2 - y1) / (x2 - x1)
        m = y1 - b * x1
        return MemoryFunction("affine", float(m), float(b))
    if family == "exp_saturation":
        # Saturation guard: when the curve is already flat at the probe
        # sizes (y2 ~ y1), the two-equation solve is degenerate and noise
        # drives m to absurd values (observed: m ~ 4e11 GB -> the
        # scheduler books ~0 for a 20 GB executor -> OOM storm). A flat
        # probe pair means the footprint HAS saturated: model it as
        # m ~ y2, fast saturation.
        if y2 / y1 < 1.02:
            return MemoryFunction("exp_saturation", float(y2 * 1.05),
                                  float(10.0 / x1))
        # solve (1-e^{-b x1})/(1-e^{-b x2}) = y1/y2 by bisection on b
        ratio = y1 / y2

        def g(b):
            return ((1.0 - np.exp(-b * x1))
                    / max(1.0 - np.exp(-b * x2), 1e-300) - ratio)
        lo, hi = 1e-12 / x2, 500.0 / x1
        # g is increasing in b (ratio -> x1/x2 at b->0, -> 1 at b->inf)
        if g(lo) > 0:
            b = lo
        elif g(hi) < 0:
            b = hi
        else:
            for _ in range(200):
                mid = np.sqrt(lo * hi)
                if g(mid) < 0:
                    lo = mid
                else:
                    hi = mid
            b = np.sqrt(lo * hi)
        m = y1 / max(1.0 - np.exp(-b * x1), 1e-300)
        return MemoryFunction("exp_saturation", float(m), float(b))
    raise ValueError(family)


# ---------------------------------------------------------------------------
# Offline least-squares fits (training programs)
# ---------------------------------------------------------------------------

def fit(family: str, xs: Sequence[float], ys: Sequence[float]
        ) -> MemoryFunction:
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    if family == "power":
        lx, ly = np.log(np.maximum(xs, 1e-12)), np.log(np.maximum(ys, 1e-12))
        b, lm = np.polyfit(lx, ly, 1)
        return MemoryFunction("power", float(np.exp(lm)), float(b))
    if family == "log":
        b, m = np.polyfit(np.log(np.maximum(xs, 1e-12)), ys, 1)
        return MemoryFunction("log", float(m), float(b))
    if family == "affine":
        b, m = np.polyfit(xs, ys, 1)
        return MemoryFunction("affine", float(m), float(b))
    if family == "exp_saturation":
        # grid over b (log-spaced), closed-form m per b, pick best
        best = (np.inf, 1.0, 1.0)
        for b in np.geomspace(1e-6 / xs.max(), 100.0 / xs.min(), 200):
            phi = 1.0 - np.exp(-b * xs)
            denom = float(phi @ phi)
            if denom <= 0:
                continue
            m = float(phi @ ys) / denom
            err = float(np.sum((m * phi - ys) ** 2))
            if err < best[0]:
                best = (err, m, b)
        return MemoryFunction("exp_saturation", best[1], float(best[2]))
    raise ValueError(family)


def relative_error(fn: Callable, xs, ys) -> float:
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    pred = np.asarray(fn(xs), np.float64)
    return float(np.mean(np.abs(pred - ys) / np.maximum(np.abs(ys), 1e-12)))


def best_family(xs, ys, families: Sequence[str] = FAMILIES
                ) -> Tuple[MemoryFunction, Dict[str, float]]:
    """Try every family; return the best fit and per-family errors."""
    errs: Dict[str, float] = {}
    best_fn, best_err = None, np.inf
    for fam in families:
        fn = fit(fam, xs, ys)
        e = relative_error(fn, xs, ys)
        errs[fam] = e
        if e < best_err:
            best_fn, best_err = fn, e
    return best_fn, errs
