"""Expert-selector classifiers (paper Table 5), from scratch in numpy.

KNN is the deployed selector (its distance doubles as a confidence
estimate and it needs no retraining when a new expert is added — paper
Section 6.9); the others exist for the Table 5 comparison:
Naive Bayes, SVM (linear, one-vs-rest hinge), MLP, Random Forest,
Decision Tree, ANN (deeper MLP).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class Classifier:
    def fit(self, X: np.ndarray, y: np.ndarray) -> "Classifier":
        raise NotImplementedError

    def predict(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def accuracy(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) == y))


@dataclass
class KNN(Classifier):
    k: int = 1
    X: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None

    def fit(self, X, y):
        self.X, self.y = np.asarray(X, float), np.asarray(y)
        return self

    def _dists(self, X):
        return np.sqrt(((X[:, None, :] - self.X[None]) ** 2).sum(-1))

    def predict(self, X):
        d = self._dists(np.asarray(X, float))
        idx = np.argsort(d, axis=1)[:, : self.k]
        votes = self.y[idx]
        out = []
        for row in votes:
            vals, counts = np.unique(row, return_counts=True)
            out.append(vals[np.argmax(counts)])
        return np.asarray(out)

    def predict_with_confidence(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """(labels, nearest-neighbour distance). The distance is the
        paper's soundness guarantee: far from every training program ->
        fall back to a conservative policy."""
        d = self._dists(np.asarray(X, float))
        nn = np.argmin(d, axis=1)
        return self.y[nn], d[np.arange(len(X)), nn]


@dataclass
class GaussianNB(Classifier):
    stats: Dict = field(default_factory=dict)

    def fit(self, X, y):
        self.stats = {}
        X = np.asarray(X, float)
        for c in np.unique(y):
            Xc = X[y == c]
            self.stats[c] = (Xc.mean(0), Xc.var(0) + 1e-6,
                             np.log(len(Xc) / len(X)))
        return self

    def predict(self, X):
        X = np.asarray(X, float)
        classes = list(self.stats)
        ll = np.stack([
            self.stats[c][2]
            - 0.5 * np.sum(np.log(2 * np.pi * self.stats[c][1]))
            - 0.5 * np.sum((X - self.stats[c][0]) ** 2
                           / self.stats[c][1], axis=1)
            for c in classes], axis=1)
        return np.asarray(classes)[np.argmax(ll, axis=1)]


@dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    label: Optional[object] = None


@dataclass
class DecisionTree(Classifier):
    max_depth: int = 8
    min_leaf: int = 1
    rng_seed: Optional[int] = None
    feature_frac: float = 1.0
    root: Optional[_Node] = None

    def fit(self, X, y):
        X, y = np.asarray(X, float), np.asarray(y)
        rng = np.random.default_rng(self.rng_seed)
        self.root = self._build(X, y, 0, rng)
        return self

    def _gini(self, y):
        _, counts = np.unique(y, return_counts=True)
        p = counts / len(y)
        return 1.0 - np.sum(p ** 2)

    def _build(self, X, y, depth, rng):
        if depth >= self.max_depth or len(np.unique(y)) == 1 \
                or len(y) <= self.min_leaf:
            vals, counts = np.unique(y, return_counts=True)
            return _Node(label=vals[np.argmax(counts)])
        d = X.shape[1]
        feats = rng.permutation(d)[: max(int(d * self.feature_frac), 1)]
        best = (np.inf, None, None)
        for f in feats:
            order = np.argsort(X[:, f])
            xs, ys = X[order, f], y[order]
            for i in range(self.min_leaf, len(y) - self.min_leaf):
                if xs[i] == xs[i - 1]:
                    continue
                g = (i * self._gini(ys[:i])
                     + (len(y) - i) * self._gini(ys[i:])) / len(y)
                if g < best[0]:
                    best = (g, f, (xs[i] + xs[i - 1]) / 2)
        if best[1] is None:
            vals, counts = np.unique(y, return_counts=True)
            return _Node(label=vals[np.argmax(counts)])
        f, t = best[1], best[2]
        lmask = X[:, f] <= t
        return _Node(feature=f, thresh=t,
                     left=self._build(X[lmask], y[lmask], depth + 1, rng),
                     right=self._build(X[~lmask], y[~lmask], depth + 1, rng))

    def predict(self, X):
        X = np.asarray(X, float)
        out = []
        for row in X:
            node = self.root
            while node.label is None:
                node = node.left if row[node.feature] <= node.thresh \
                    else node.right
            out.append(node.label)
        return np.asarray(out)


@dataclass
class RandomForest(Classifier):
    n_trees: int = 20
    max_depth: int = 8
    seed: int = 0
    trees: List[DecisionTree] = field(default_factory=list)

    def fit(self, X, y):
        X, y = np.asarray(X, float), np.asarray(y)
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for t in range(self.n_trees):
            idx = rng.integers(0, len(y), len(y))
            tree = DecisionTree(max_depth=self.max_depth,
                                rng_seed=int(rng.integers(1 << 31)),
                                feature_frac=0.7)
            tree.fit(X[idx], y[idx])
            self.trees.append(tree)
        return self

    def predict(self, X):
        votes = np.stack([t.predict(X) for t in self.trees], axis=1)
        out = []
        for row in votes:
            vals, counts = np.unique(row, return_counts=True)
            out.append(vals[np.argmax(counts)])
        return np.asarray(out)


@dataclass
class LinearSVM(Classifier):
    """One-vs-rest linear SVM, hinge loss, SGD."""
    lr: float = 0.05
    epochs: int = 300
    reg: float = 1e-3
    W: Optional[np.ndarray] = None
    b: Optional[np.ndarray] = None
    classes: Optional[np.ndarray] = None

    def fit(self, X, y):
        X = np.asarray(X, float)
        self.classes = np.unique(y)
        C, d = len(self.classes), X.shape[1]
        self.W = np.zeros((C, d))
        self.b = np.zeros(C)
        rng = np.random.default_rng(0)
        for ci, c in enumerate(self.classes):
            t = np.where(y == c, 1.0, -1.0)
            w, bb = np.zeros(d), 0.0
            for _ in range(self.epochs):
                order = rng.permutation(len(t))
                for i in order:
                    margin = t[i] * (X[i] @ w + bb)
                    if margin < 1:
                        w = (1 - self.lr * self.reg) * w \
                            + self.lr * t[i] * X[i]
                        bb += self.lr * t[i]
                    else:
                        w = (1 - self.lr * self.reg) * w
            self.W[ci], self.b[ci] = w, bb
        return self

    def predict(self, X):
        scores = np.asarray(X, float) @ self.W.T + self.b
        return self.classes[np.argmax(scores, axis=1)]


@dataclass
class MLP(Classifier):
    """Small fully-connected net, softmax CE, Adam. hidden=(32,) is the
    paper's MLP row; ANN uses a deeper variant (3 layers, backprop)."""
    hidden: Tuple[int, ...] = (32,)
    lr: float = 0.01
    epochs: int = 400
    seed: int = 0
    params: Optional[list] = None
    classes: Optional[np.ndarray] = None

    def fit(self, X, y):
        X = np.asarray(X, float)
        self.classes = np.unique(y)
        yid = np.searchsorted(self.classes, y)
        rng = np.random.default_rng(self.seed)
        sizes = [X.shape[1], *self.hidden, len(self.classes)]
        self.params = [
            (rng.normal(0, np.sqrt(2.0 / sizes[i]),
                        (sizes[i], sizes[i + 1])),
             np.zeros(sizes[i + 1]))
            for i in range(len(sizes) - 1)]
        mom = [(np.zeros_like(w), np.zeros_like(b),
                np.zeros_like(w), np.zeros_like(b))
               for w, b in self.params]
        onehot = np.eye(len(self.classes))[yid]
        for step in range(1, self.epochs + 1):
            acts = [X]
            for li, (w, b) in enumerate(self.params):
                z = acts[-1] @ w + b
                acts.append(np.maximum(z, 0)
                            if li < len(self.params) - 1 else z)
            z = acts[-1] - acts[-1].max(1, keepdims=True)
            p = np.exp(z)
            p /= p.sum(1, keepdims=True)
            delta = (p - onehot) / len(X)
            new_mom, grads = [], []
            for li in reversed(range(len(self.params))):
                w, b = self.params[li]
                gw = acts[li].T @ delta
                gb = delta.sum(0)
                grads.append((li, gw, gb))
                if li > 0:
                    delta = (delta @ w.T) * (acts[li] > 0)
            for li, gw, gb in grads:
                w, b = self.params[li]
                mw, mb, vw, vb = mom[li]
                mw = 0.9 * mw + 0.1 * gw
                mb = 0.9 * mb + 0.1 * gb
                vw = 0.999 * vw + 0.001 * gw ** 2
                vb = 0.999 * vb + 0.001 * gb ** 2
                mom[li] = (mw, mb, vw, vb)
                bc1 = 1 - 0.9 ** step
                bc2 = 1 - 0.999 ** step
                self.params[li] = (
                    w - self.lr * (mw / bc1)
                    / (np.sqrt(vw / bc2) + 1e-8),
                    b - self.lr * (mb / bc1)
                    / (np.sqrt(vb / bc2) + 1e-8))
            del new_mom
        return self

    def predict(self, X):
        a = np.asarray(X, float)
        for li, (w, b) in enumerate(self.params):
            a = a @ w + b
            if li < len(self.params) - 1:
                a = np.maximum(a, 0)
        return self.classes[np.argmax(a, axis=1)]


def make_table5_classifiers() -> Dict[str, Classifier]:
    return {
        "Naive Bayes": GaussianNB(),
        "SVM": LinearSVM(),
        "MLP": MLP(hidden=(32,)),
        "Random Forests": RandomForest(),
        "Decision Tree": DecisionTree(),
        "ANN": MLP(hidden=(64, 32)),
        "KNN": KNN(k=1),
    }
