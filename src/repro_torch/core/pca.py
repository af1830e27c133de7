"""PCA + varimax rotation (paper Sections 3.2, Figure 4) — numpy only."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Scaler:
    """Paper-style [0,1] min-max scaling; train-set bounds reused at
    deployment."""
    lo: np.ndarray
    hi: np.ndarray

    @classmethod
    def fit(cls, X: np.ndarray) -> "Scaler":
        return cls(lo=X.min(axis=0), hi=X.max(axis=0))

    def transform(self, X: np.ndarray) -> np.ndarray:
        span = np.maximum(self.hi - self.lo, 1e-12)
        return np.clip((X - self.lo) / span, -0.5, 1.5)


@dataclass
class PCA:
    mean: np.ndarray
    components: np.ndarray        # [k, d]
    explained_ratio: np.ndarray   # [k]

    @classmethod
    def fit(cls, X: np.ndarray, n_components: Optional[int] = None,
            variance: float = 0.95) -> "PCA":
        """Keep n_components, or enough PCs for ``variance`` of the total
        (the paper keeps the top 5 PCs ~ 95%)."""
        mean = X.mean(axis=0)
        Xc = X - mean
        _, s, vt = np.linalg.svd(Xc, full_matrices=False)
        var = s ** 2
        ratio = var / max(var.sum(), 1e-12)
        if n_components is None:
            n_components = int(np.searchsorted(np.cumsum(ratio),
                                               variance) + 1)
            n_components = min(n_components, len(ratio))
        return cls(mean=mean, components=vt[:n_components],
                   explained_ratio=ratio[:n_components])

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mean) @ self.components.T


def varimax(loadings: np.ndarray, gamma: float = 1.0, iters: int = 100,
            tol: float = 1e-8) -> np.ndarray:
    """Varimax rotation of a [d, k] loading matrix (paper Fig. 4b uses it
    to attribute PC variance back to raw features)."""
    d, k = loadings.shape
    R = np.eye(k)
    var_old = 0.0
    for _ in range(iters):
        L = loadings @ R
        u, s, vt = np.linalg.svd(
            loadings.T @ (L ** 3 - (gamma / d) * L
                          @ np.diag(np.sum(L ** 2, axis=0))))
        R = u @ vt
        var_new = float(np.sum(s))
        if var_new - var_old < tol:
            break
        var_old = var_new
    return loadings @ R


def feature_importance(pca: PCA) -> np.ndarray:
    """Per-raw-feature importance: |varimax-rotated loadings| weighted by
    explained variance. Returns [d] scores."""
    # components: [k, d] -> loadings [d, k]
    load = (pca.components * pca.explained_ratio[:, None]).T
    rot = varimax(load)
    return np.abs(rot).sum(axis=1)
