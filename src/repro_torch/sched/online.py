"""Online predictor refresh: fold profiled arrivals back into the model.

The MoE predictor is trained offline on 16 programs; an open arrival
stream keeps surfacing workloads the selector has never seen (KNN
distance beyond the confidence threshold -> conservative scheduling,
half-sized executors). But every such arrival *is profiled anyway* —
the feature probe plus the 5%/10% calibration runs trace out a small
memory curve. :class:`OnlineRefresher` turns that by-product into
training signal: when the curve is cleanly explained by one expert
family, the (features, family) pair is appended to the KNN selector via
:meth:`repro_torch.core.predictor.MoEPredictor.partial_update` — no PCA refit,
no re-profiling of the original training programs.

The refresher only folds in arrivals the selector was NOT confident
about (confident ones add no information and would bloat the KNN table)
and only when the best family fit is unambiguous, so a noisy probe
cannot poison the selector.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import experts


@dataclass
class OnlineRefresher:
    """Streams (features, probe curve) observations into an estimator.

    ``predictor`` is duck-typed against the
    :class:`~repro_torch.sched.estimator.DemandEstimator` protocol surface
    (``families``, ``select_family``, ``partial_update``) — pass the
    registry handle (e.g. ``get_estimator("moe", predictor=moe)``)
    rather than reaching into ``MoEPredictor`` internals; a bare fitted
    ``MoEPredictor`` still works.  Estimators that do not learn online
    return ``False`` from ``partial_update`` and the offer is counted
    as rejected."""
    predictor: object                  # DemandEstimator / MoEPredictor
    max_error: float = 0.05            # accept only clean family fits
    ambiguity_ratio: float = 2.0       # runner-up must be this much worse
    min_probes: int = 3
    only_unconfident: bool = True
    max_updates: int = 256             # bound the KNN table growth
    accepted: int = 0
    rejected: int = 0
    table_full: int = 0                # offers dropped after max_updates
    history: list = field(default_factory=list)

    def observe(self, features: np.ndarray, xs: Sequence[float],
                ys: Sequence[float],
                confident: Optional[bool] = None) -> Optional[str]:
        """Offer one profiled arrival. Returns the family folded in, or
        None when the observation was rejected (already confident,
        ambiguous fit, or table full).

        Callers that already ran the selector (the scheduler computes
        confidence for every prediction anyway) pass ``confident`` to
        skip a duplicate KNN query on the per-job hot path."""
        if self.accepted >= self.max_updates:
            self.table_full += 1
            return None
        xs = np.asarray(xs, float)
        ys = np.asarray(ys, float)
        if len(xs) < self.min_probes:
            self.rejected += 1
            return None
        features = np.asarray(features, float)
        if self.only_unconfident:
            if confident is None:
                sel = getattr(self.predictor, "select_family", None)
                # estimators without a selector have no confidence
                # signal — treat the arrival as unconfident (offer it)
                confident = sel(features)[2] if sel is not None else False
            if confident:
                self.rejected += 1
                return None
        fn, errs = experts.best_family(xs, ys, self.predictor.families)
        if errs[fn.family] > self.max_error:
            self.rejected += 1
            return None
        # unambiguous means the winner BEATS the field, not merely fits:
        # on a flat probe curve every family fits within tolerance and
        # the argmin is noise — folding that in would permanently label
        # the cluster with an arbitrary family
        others = [e for fam, e in errs.items() if fam != fn.family]
        if others and min(others) < max(
                errs[fn.family] * self.ambiguity_ratio, 1e-3):
            self.rejected += 1
            return None
        # the predictor may still drop the row as a near-duplicate of an
        # existing same-family row (table hygiene) — count that as a
        # rejection, not a fold
        if self.predictor.partial_update(features, fn.family) is False:
            self.rejected += 1
            return None
        self.accepted += 1
        self.history.append(fn.family)
        return fn.family

    def stats(self) -> Dict[str, int]:
        return {"accepted": self.accepted, "rejected": self.rejected,
                "table_full": self.table_full}
