"""The paper's contribution: mixture-of-experts memory prediction.

Offline (``fit``): profile each training program across input sizes, fit
every expert family, label the program with the best one; learn the
[0,1] feature scaler, PCA projection, and the KNN expert selector.

Runtime (``predict_function``): extract the target's features (100MB-ish
probe), scale + project, KNN-select the family (distance = confidence;
beyond ``fallback_distance`` the scheduler uses a conservative policy),
then two-point-calibrate (5%/10% probes) to instantiate (m, b).

Unified baselines for Fig. 9 / QUASAR: single-family predictors and an
ANN regressor over (features, x) -> y.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import experts
from repro_torch.core.classifiers import KNN, MLP
from repro_torch.core.experts import MemoryFunction
from repro_torch.core.pca import PCA, Scaler
from repro_torch.core.workloads import AppProfile

PROFILE_SIZES = (0.3, 3.0, 30.0, 100.0, 300.0, 1000.0)  # M-items sweep


def calibration_points(total_items: float) -> np.ndarray:
    """The runtime calibration sizes (paper Section 4.1): the ~100MB
    feature-extraction probe plus the 5% and 10% runs.  Shared with
    ``repro_torch.sched.estimator`` so predicted side-car curves are probed at
    exactly the same input sizes as the primary memory curve."""
    return np.asarray([min(0.1, 0.01 * total_items),
                       0.05 * total_items, 0.10 * total_items])


def profile_curve(app: AppProfile, rng: np.random.Generator,
                  sizes: Sequence[float] = PROFILE_SIZES
                  ) -> Tuple[np.ndarray, np.ndarray]:
    xs = np.asarray(sizes, float)
    ys = np.asarray([app.measure(x, rng) for x in xs])
    return xs, ys


@dataclass
class MoEPredictor:
    families: Sequence[str] = experts.FAMILIES
    knn_k: int = 1
    fallback_distance: float = 0.35
    # online-row hygiene: a new row whose features sit within
    # ``dedupe_tol`` (RMS per-dim distance, raw feature space) of an
    # existing row with the SAME family adds no information — drop it;
    # and at most ``max_online_rows`` online rows are kept, evicting the
    # OLDEST online row first (offline training rows are never evicted)
    dedupe_tol: float = 0.05
    max_online_rows: int = 256
    scaler: Optional[Scaler] = None
    pca: Optional[PCA] = None
    knn: Optional[KNN] = None
    train_labels: Dict[str, str] = field(default_factory=dict)
    # raw (features, family) rows backing the KNN table — kept so online
    # partial updates can re-project when the scaler envelope widens
    _X_raw: Optional[np.ndarray] = None
    _y_raw: Optional[np.ndarray] = None
    _n_fit: int = 0                    # offline rows; rows beyond are online

    def fit(self, train_apps: List[AppProfile], seed: int = 0
            ) -> "MoEPredictor":
        rng = np.random.default_rng(seed)
        X, y = [], []
        for app in train_apps:
            xs, ys = profile_curve(app, rng)
            fn, _ = experts.best_family(xs, ys, self.families)
            self.train_labels[app.name] = fn.family
            X.append(app.features)
            y.append(fn.family)
        X = np.asarray(X, float)
        self._X_raw = X
        self._y_raw = np.asarray(y)
        self._n_fit = len(X)
        self.scaler = Scaler.fit(X)
        Xs = self.scaler.transform(X)
        self.pca = PCA.fit(Xs, n_components=min(5, Xs.shape[1]))
        self.knn = KNN(k=self.knn_k).fit(self.pca.transform(Xs),
                                         np.asarray(y))
        return self

    @property
    def n_online_rows(self) -> int:
        return len(self._X_raw) - self._n_fit if self._X_raw is not None \
            else 0

    def _is_duplicate(self, f: np.ndarray, family: str) -> bool:
        same = self._y_raw == family
        if not np.any(same):
            return False
        d = self._X_raw[same] - f[None, :]
        rms = np.sqrt(np.mean(d * d, axis=1))
        return bool(np.min(rms) <= self.dedupe_tol)

    def _drop_row(self, idx: int) -> None:
        """Remove row ``idx`` from the raw table AND the projected KNN
        table (rows correspond 1:1 in both append and rebuild paths)."""
        self._X_raw = np.delete(self._X_raw, idx, axis=0)
        self._y_raw = np.delete(self._y_raw, idx)
        self.knn.X = np.delete(self.knn.X, idx, axis=0)
        self.knn.y = np.delete(self.knn.y, idx)

    def partial_update(self, features: np.ndarray, family: str) -> bool:
        """Online refresh hook (used by repro_torch.sched.online): fold ONE
        newly profiled program into the selector without a full refit —
        no re-profiling of training programs, no PCA re-fit.  Returns
        False when the row was dropped as a near-duplicate.

        The new row is appended to the KNN table; if it falls outside
        the training envelope, the [0,1] scaler bounds widen and the
        stored rows are re-projected through the FIXED PCA basis (an
        O(n*d) matrix multiply).  The table is bounded: a row within
        ``dedupe_tol`` of an existing same-family row is rejected, and
        beyond ``max_online_rows`` online rows the oldest online row is
        evicted (training rows are permanent)."""
        if self.knn is None:
            raise RuntimeError("partial_update() requires a fitted "
                               "predictor")
        f = np.asarray(features, float)
        if self._is_duplicate(f, family):
            return False
        if self.max_online_rows <= 0:
            return False                   # online rows disabled
        if self.n_online_rows >= self.max_online_rows:
            self._drop_row(self._n_fit)    # oldest online row
        self._X_raw = np.vstack([self._X_raw, f[None, :]])
        self._y_raw = np.append(self._y_raw, family)
        lo = np.minimum(self.scaler.lo, f)
        hi = np.maximum(self.scaler.hi, f)
        if np.any(lo < self.scaler.lo) or np.any(hi > self.scaler.hi):
            # a wider envelope CONTRACTS every scaled coordinate, so KNN
            # distances shrink against the fixed confidence threshold —
            # shrink the threshold by the same (geometric-mean) factor
            # or a second unseen cluster would suddenly look "near" and
            # lose the paper's distance-based soundness fallback
            old_span = np.maximum(self.scaler.hi - self.scaler.lo, 1e-12)
            new_span = np.maximum(hi - lo, 1e-12)
            self.fallback_distance *= float(
                np.exp(np.mean(np.log(old_span / new_span))))
            self.scaler = Scaler(lo=lo, hi=hi)
            Z = self.pca.transform(self.scaler.transform(self._X_raw))
            self.knn = KNN(k=self.knn_k).fit(Z, self._y_raw)
        else:
            z = self.pca.transform(self.scaler.transform(f[None, :]))
            self.knn.X = np.vstack([self.knn.X, z])
            self.knn.y = np.append(self.knn.y, family)
        return True

    # --- runtime ---------------------------------------------------------
    def select_family(self, features: np.ndarray
                      ) -> Tuple[str, float, bool]:
        """Returns (family, distance, confident)."""
        Z = self.pca.transform(
            self.scaler.transform(features[None, :]))
        labels, dist = self.knn.predict_with_confidence(Z)
        return str(labels[0]), float(dist[0]), float(dist[0]) <= \
            self.fallback_distance

    def predict_function(self, app: AppProfile, total_items: float,
                         rng: np.random.Generator
                         ) -> Tuple[MemoryFunction, Dict]:
        """Full runtime path: select family, then calibrate on the 5% and
        10% probes (paper Section 4.1) PLUS the ~100MB feature-extraction
        probe, whose footprint was measured anyway — the extra small-x
        anchor pins the curve in the per-executor-allocation regime
        (two knee-region points alone extrapolate poorly; measured:
        large exp-saturation jobs over-provisioned ~2x at chunk scale)."""
        fam, dist, confident = self.select_family(app.features)
        xs = calibration_points(total_items)
        ys = np.asarray([app.measure(x, rng) for x in xs])
        fn = experts.fit(fam, xs, ys)
        info = {"family": fam, "distance": dist, "confident": confident,
                "calib": list(zip(xs.tolist(), ys.tolist()))}
        return fn, info


@dataclass
class UnifiedFamilyPredictor:
    """Fig. 9 baseline: ONE family for every application."""
    family: str

    def predict_function(self, app: AppProfile, total_items: float,
                         rng: np.random.Generator
                         ) -> Tuple[MemoryFunction, Dict]:
        x1, x2 = 0.05 * total_items, 0.10 * total_items
        y1, y2 = app.measure(x1, rng), app.measure(x2, rng)
        fn = experts.calibrate_two_point(self.family, x1, y1, x2, y2)
        return fn, {"family": self.family}

    def fit(self, train_apps, seed: int = 0):
        return self


@dataclass
class ANNPredictor:
    """Fig. 9's strongest unified baseline / QUASAR's estimator: a neural
    net regressor over (features, log-x) -> log-y trained on the training
    programs' curves. One monolithic model — exactly what the paper argues
    cannot capture diverse behaviors."""
    hidden: Tuple[int, ...] = (64, 32)
    epochs: int = 600
    lr: float = 0.01
    _mlp: Optional[MLP] = None
    _W: Optional[list] = None
    scaler: Optional[Scaler] = None
    _ymean: float = 0.0
    _ystd: float = 1.0

    def fit(self, train_apps: List[AppProfile], seed: int = 0
            ) -> "ANNPredictor":
        rng = np.random.default_rng(seed)
        X, t = [], []
        feats = np.asarray([a.features for a in train_apps])
        self.scaler = Scaler.fit(feats)
        for app in train_apps:
            xs, ys = profile_curve(app, rng)
            f = self.scaler.transform(app.features[None, :])[0]
            for x, y in zip(xs, ys):
                X.append(np.concatenate([f, [np.log(x)]]))
                t.append(np.log(max(y, 1e-6)))
        X = np.asarray(X, float)
        t = np.asarray(t, float)
        self._ymean, self._ystd = float(t.mean()), float(t.std() + 1e-9)
        tn = (t - self._ymean) / self._ystd
        # tiny numpy MLP regressor (Adam, MSE)
        sizes = [X.shape[1], *self.hidden, 1]
        rg = np.random.default_rng(seed)
        W = [(rg.normal(0, np.sqrt(2 / sizes[i]), (sizes[i], sizes[i + 1])),
              np.zeros(sizes[i + 1])) for i in range(len(sizes) - 1)]
        mom = [(np.zeros_like(w), np.zeros_like(b), np.zeros_like(w),
                np.zeros_like(b)) for w, b in W]
        for step in range(1, self.epochs + 1):
            acts = [X]
            for li, (w, b) in enumerate(W):
                z = acts[-1] @ w + b
                acts.append(np.maximum(z, 0) if li < len(W) - 1 else z)
            delta = (acts[-1][:, 0] - tn)[:, None] * (2.0 / len(X))
            grads = []
            for li in reversed(range(len(W))):
                w, b = W[li]
                grads.append((li, acts[li].T @ delta, delta.sum(0)))
                if li > 0:
                    delta = (delta @ w.T) * (acts[li] > 0)
            for li, gw, gb in grads:
                w, b = W[li]
                mw, mb, vw, vb = mom[li]
                mw = 0.9 * mw + 0.1 * gw
                mb = 0.9 * mb + 0.1 * gb
                vw = 0.999 * vw + 0.001 * gw ** 2
                vb = 0.999 * vb + 0.001 * gb ** 2
                mom[li] = (mw, mb, vw, vb)
                bc1, bc2 = 1 - 0.9 ** step, 1 - 0.999 ** step
                W[li] = (w - self.lr * (mw / bc1)
                         / (np.sqrt(vw / bc2) + 1e-8),
                         b - self.lr * (mb / bc1)
                         / (np.sqrt(vb / bc2) + 1e-8))
        self._W = W
        return self

    def _predict_log_y(self, features: np.ndarray, x: float) -> float:
        f = self.scaler.transform(features[None, :])[0]
        a = np.concatenate([f, [np.log(max(x, 1e-9))]])[None, :]
        for li, (w, b) in enumerate(self._W):
            a = a @ w + b
            if li < len(self._W) - 1:
                a = np.maximum(a, 0)
        return float(a[0, 0]) * self._ystd + self._ymean

    def predict_function(self, app: AppProfile, total_items: float,
                         rng: np.random.Generator
                         ) -> Tuple[MemoryFunction, Dict]:
        """Sample the net once on a log grid and return a fast
        interpolating curve (keeps the scheduler interface uniform)."""
        grid = np.geomspace(1e-4, max(total_items * 2, 1.0), 64)
        logy = np.asarray([self._predict_log_y(app.features, xi)
                           for xi in grid])
        return SampledFn(np.log(grid), logy), {"family": "ann"}


class SampledFn(MemoryFunction):
    """Monotone-ish log-log interpolated curve (see ANNPredictor)."""

    def __init__(self, logx, logy):
        object.__setattr__(self, "family", "ann")
        object.__setattr__(self, "m", 0.0)
        object.__setattr__(self, "b", 0.0)
        object.__setattr__(self, "logx", logx)
        object.__setattr__(self, "logy", logy)

    def __call__(self, x):
        lx = np.log(np.maximum(np.asarray(x, float), 1e-12))
        out = np.exp(np.interp(lx, self.logx, self.logy))
        return out if np.ndim(x) else float(out)

    def inverse(self, y: float, x_hint: float = 1.0) -> float:
        ys = np.exp(self.logy)
        # first grid point exceeding the budget (curve may be non-monotone)
        over = np.nonzero(ys > y)[0]
        if len(over) == 0:
            return np.inf
        if over[0] == 0:
            return 0.0
        i = over[0]
        # log-linear interpolation between grid points i-1 and i
        ly = np.log(max(y, 1e-12))
        t = (ly - self.logy[i - 1]) / max(
            self.logy[i] - self.logy[i - 1], 1e-12)
        return float(np.exp(self.logx[i - 1]
                            + t * (self.logx[i] - self.logx[i - 1])))


class OraclePredictor:
    """Prophetic: returns the ground-truth function, no profiling cost."""

    def fit(self, train_apps, seed: int = 0):
        return self

    def predict_function(self, app: AppProfile, total_items: float,
                         rng: np.random.Generator
                         ) -> Tuple[MemoryFunction, Dict]:
        return app.true_fn, {"family": app.family, "oracle": True}
