"""Workload universes for the co-location experiments.

* ``spark_sim_suite`` — the faithful reproduction: 44 applications named
  after the paper's four suites (16 HiBench+BigDataBench training apps,
  28 Spark-Perf/Spark-Bench test apps), each with a ground-truth memory
  curve from one of the paper's three families (+ measurement noise), a
  CPU load drawn from the paper's Fig.13 distribution, and a 22-dim
  runtime feature vector that clusters by family (paper Fig.16).

* ``tpu_jobs_suite`` — the beyond-paper universe: the assigned
  (arch x shape) cells as schedulable jobs whose memory curves come from
  the real model configs (param bytes + per-token activation/KV bytes)
  and whose duty cycles come from the dry-run roofline.

Units: x = input size in M-items (spark) or k-tokens (tpu); y = GB.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.experts import MemoryFunction

FEATURE_NAMES = [
    "L1_TCM", "L1_DCM", "vcache", "L1_STM", "bo", "L2_TCM", "L3_TCM", "cs",
    "FLOPs", "in", "L2_DCM", "L2_LDM", "L1_ICM", "swpd", "L2_STM", "IPC",
    "L1_LDM", "L2_ICM", "ID", "WA", "US", "SY",
]

# suite -> [(app, family)]
_HB = [("Sort", "exp_saturation"), ("TeraSort", "exp_saturation"),
       ("Wordcount", "exp_saturation"), ("PageRank", "log"),
       ("Kmeans", "power"), ("Join", "exp_saturation"),
       ("Scan", "exp_saturation"), ("Aggregation", "power"),
       ("Bayes", "power")]
_BDB = [("Sort", "exp_saturation"), ("Wordcount", "exp_saturation"),
        ("Grep", "exp_saturation"), ("PageRank", "log"),
        ("Kmeans", "power"), ("NaiveBayes", "power"),
        ("Join", "exp_saturation")]
_SP = [("Kmeans", "power"), ("glm-classification", "power"),
       ("glm-regression", "power"), ("Pca", "power"),
       ("NaiveBayes", "power"), ("DecisionTree", "power"),
       ("Spearman", "power"), ("Pearson", "power"), ("Chi-sq", "power"),
       ("Gmm", "power"), ("Sum.Statis", "power"),
       ("B.MatrixMult", "exp_saturation"), ("CoreRDD", "exp_saturation"),
       ("ALS", "log"), ("FPGrowth", "power")]
_SB = [("Hive", "exp_saturation"), ("SVD++", "log"), ("MatrixFact", "log"),
       ("LogRegre", "power"), ("RDDRelation", "exp_saturation"),
       ("SQL", "exp_saturation"), ("PageRank", "log"), ("SVM", "power"),
       ("TriangleCount", "log"), ("ConnectedComp", "log"),
       ("Terasort", "exp_saturation"), ("DecisionTree", "power"),
       ("PregelOp", "log")]

TRAIN_SUITES = ("HB", "BDB")
INPUT_SIZES_M_ITEMS = {"small": 0.3, "medium": 30.0, "large": 1000.0}


def size_class_of(items: float) -> str:
    """Nearest paper Table-4 size class for an input size (used for
    per-class reporting of open-arrival streams)."""
    classes = list(INPUT_SIZES_M_ITEMS)
    logs = np.log(np.asarray(list(INPUT_SIZES_M_ITEMS.values())))
    return classes[int(np.argmin(np.abs(
        logs - np.log(max(float(items), 1e-12)))))]

# family -> 22-dim cluster center in [0,1] feature space (three tight
# clusters; paper Fig.16 / Section 6.9: within-cluster corr > 0.9999)
_CENTER_SEED = 7


def _family_centers() -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(_CENTER_SEED)
    return {fam: rng.uniform(0.15, 0.85, len(FEATURE_NAMES))
            for fam in ("power", "exp_saturation", "log")}


@dataclass
class AppProfile:
    name: str
    suite: str
    family: str                 # ground-truth memory-function family
    true_fn: MemoryFunction     # GB as a function of M-items
    cpu_load: float             # average duty cycle in isolation (0..1)
    rate: float                 # M-items / s per executor (unit share)
    features: np.ndarray        # 22-dim raw feature vector
    noise: float = 0.02         # multiplicative measurement noise
    # GROUND-TRUTH secondary-axis demand curves (axis -> units->amount),
    # e.g. host staging RAM or interconnect bandwidth for an
    # HBM-resident TPU job.  Since the DemandEstimator redesign these
    # are a measurement source only (``measure_axis``): the runtime
    # PREDICTS the side-car curves from probes, and feeding declared
    # curves straight into admission is deprecated (DeprecationWarning
    # from the legacy path in ``core/simulator.py``).
    aux_demand: Dict[str, MemoryFunction] = field(default_factory=dict)

    def measure(self, x: float, rng: Optional[np.random.Generator] = None
                ) -> float:
        y = float(self.true_fn(x))
        if rng is not None:
            y *= float(1.0 + rng.normal(0, self.noise))
        return max(y, 1e-3)

    def measure_axis(self, axis: str, x: float,
                     rng: Optional[np.random.Generator] = None) -> float:
        """Measure a side-car axis at input size ``x`` (the aux-probe
        counterpart of :meth:`measure`, same noise model).  This is how
        estimators *predict* aux curves instead of reading the declared
        ground truth."""
        y = float(self.aux_demand[axis](x))
        if rng is not None:
            y *= float(1.0 + rng.normal(0, self.noise))
        return max(y, 1e-6)


def _make_fn(fam: str, rng: np.random.Generator) -> MemoryFunction:
    """Parameter ranges chosen so a Spark-partition chunk of a large input
    (~6-25 M-items) has a 10-45 GB footprint — memory is the binding
    co-location constraint, as in the paper (64 GB hosts, executors sized
    to tens of GB)."""
    if fam == "power":
        return MemoryFunction("power", float(rng.uniform(7.0, 18.0)),
                              float(rng.uniform(0.35, 0.6)))
    if fam == "exp_saturation":
        return MemoryFunction("exp_saturation",
                              float(rng.uniform(45.0, 120.0)),
                              float(rng.uniform(0.01, 0.05)))
    if fam == "log":
        return MemoryFunction("log", float(rng.uniform(16.0, 36.0)),
                              float(rng.uniform(2.0, 5.0)))
    raise ValueError(fam)


def spark_sim_suite(seed: int = 0) -> List[AppProfile]:
    rng = np.random.default_rng(seed)
    centers = _family_centers()
    apps: List[AppProfile] = []
    for suite, entries in (("HB", _HB), ("BDB", _BDB), ("SP", _SP),
                           ("SB", _SB)):
        for name, fam in entries:
            fn = _make_fn(fam, rng)
            # Fig 13: CPU load mostly < 40%; compute-heavy apps higher
            heavy = name in ("Aggregation", "Kmeans", "Gmm",
                             "glm-classification", "SVM", "FPGrowth")
            cpu = float(np.clip(rng.normal(0.45 if heavy else 0.28, 0.08),
                                0.08, 0.75))
            feat = np.clip(
                centers[fam] + rng.normal(0, 0.015, len(FEATURE_NAMES)),
                0, 1)
            apps.append(AppProfile(
                name=f"{suite}.{name}", suite=suite, family=fam,
                true_fn=fn, cpu_load=cpu,
                rate=float(rng.uniform(0.02, 0.12)), features=feat))
    assert len(apps) == 44, len(apps)
    return apps


def training_apps(apps: List[AppProfile]) -> List[AppProfile]:
    return [a for a in apps if a.suite in TRAIN_SUITES]


def loocv_training_set(apps: List[AppProfile], target: AppProfile
                       ) -> List[AppProfile]:
    """Leave-one-out + exclude equivalent implementations in other suites
    (paper Section 5.2: testing HB.Sort excludes BDB.Sort too)."""
    base = target.name.split(".", 1)[1].lower()
    return [a for a in training_apps(apps)
            if a.name != target.name
            and a.name.split(".", 1)[1].lower() != base]


# ---------------------------------------------------------------------------
# TPU-jobs universe (beyond paper): assigned cells as schedulable jobs
# ---------------------------------------------------------------------------

def tpu_jobs_suite(dryrun_results: Optional[dict] = None, seed: int = 0
                   ) -> List[AppProfile]:
    """Jobs = assigned (arch x shape) cells. Memory curve per job:
    y(GB) = weight GB + per-ktoken GB * x  (affine ground truth — exactly
    the degenerate case the paper's 3-family library cannot express,
    motivating the pluggable `affine` expert). Duty cycle = roofline
    compute-term share from the dry-run when available."""
    from repro_torch.configs import ARCH_IDS, get_config, applicable_shapes
    from repro_torch.models import model as model_lib
    from repro_torch.utils.tree import tree_bytes

    rng = np.random.default_rng(seed)
    centers = _family_centers()
    ssm_center = np.clip(
        np.random.default_rng(_CENTER_SEED + 1).uniform(
            0.15, 0.85, len(FEATURE_NAMES)), 0, 1)
    jobs: List[AppProfile] = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        pb = tree_bytes(model_lib.abstract(cfg)) / 2 ** 30  # GB
        d = cfg.d_model
        for shape_name in applicable_shapes(cfg):
            # per-ktoken activation/KV GB (order-of-magnitude model:
            # activations ~ layers * d * bytes; KV ~ layers * kv * hd)
            if shape_name.startswith("decode") or shape_name.startswith(
                    "long"):
                per_tok = (cfg.num_layers * cfg.num_kv_heads
                           * max(cfg.head_dim, 1) * 2 * 2) / 2 ** 30 * 1000
                fam = "affine" if cfg.family in ("ssm", "hybrid") \
                    else "affine"
            else:
                per_tok = (cfg.num_layers * d * 4 * 2) / 2 ** 30 * 1000
                fam = "affine"
            duty = 0.35
            key = f"{arch}|{shape_name}|single"
            if dryrun_results and key in dryrun_results \
                    and dryrun_results[key].get("ok"):
                r = dryrun_results[key]["roofline"]
                tot = max(r["compute_s"] + r["memory_s"]
                          + r["collective_s"], 1e-9)
                duty = float(np.clip(r["compute_s"] / tot, 0.05, 0.95))
            fn = MemoryFunction("affine", float(pb), float(per_tok))
            feat = np.clip(
                (ssm_center if cfg.family in ("ssm", "hybrid")
                 else centers["power"])
                + rng.normal(0, 0.015, len(FEATURE_NAMES)), 0, 1)
            jobs.append(AppProfile(
                name=f"{arch}:{shape_name}", suite="TPU", family=fam,
                true_fn=fn, cpu_load=duty,
                rate=float(rng.uniform(0.02, 0.12)), features=feat))
    return jobs
