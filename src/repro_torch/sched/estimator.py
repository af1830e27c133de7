"""Unified demand estimation: ONE predicted multi-axis entry point.

The paper's contribution is *predicting* an application's memory
function (MoE selector + two-point calibration) and inverting it under
a budget.  Before this module, the demand side was scattered: the
predictor handed back a scalar curve, ``DemandModel`` bundled it with
*declared* side-car curves (``AppProfile.aux_demand``), and serving kept
its own calibration cache.  Every admission consumer now goes through a
single pluggable API:

* :class:`DemandEstimator` — protocol ``estimate(target, probes) ->
  DemandEstimate``: a full multi-axis :class:`~repro_torch.sched.resources.
  DemandModel` plus per-axis confidence and a conservative-fallback
  flag.  Estimators that learn online also expose ``partial_update``
  (the :class:`~repro_torch.sched.online.OnlineRefresher` hook).
* a registry mirroring ``repro_torch.sched.placement`` —
  ``register_estimator`` / ``get_estimator`` / ``available_estimators``
  — selectable per run via ``SimConfig.estimator``,
  ``benchmarks/run.py --estimator`` and ``launch/serve.py
  --estimator``.

Registered implementations:

``moe``            the flagship (paper): KNN family selection +
                   two-point calibration on the 5%/10% probes, PLUS
                   **predicted** side-car curves — each aux axis the
                   workload exposes (host staging RAM, interconnect
                   ``net``) is probed at the same input sizes and fitted
                   (``net`` with the simple linear contention curve,
                   other axes with the best expert family), replacing
                   the deprecated declared ``AppProfile.aux_demand``
                   consumption.
``oracle``         ground-truth curves on every axis, confidence 1.0.
``single-family``  one expert family for everything (Fig. 9 baseline).
``ann``            the QUASAR-style monolithic regressor baseline.
``conservative``   no learned selector: best probe fit, always flagged
                   conservative (the scheduler halves memory budgets —
                   paper Section 6.9); on serving targets it pads the
                   calibrated footprint instead.
``kv-growth``      the serving footprint: two-point affine calibration
                   of weights+KV vs batch at ``max_len`` — this
                   estimator owns the per-``(config, max_len)``
                   calibration cache that used to live on
                   ``DemandModel.from_model_config`` (now a deprecated
                   bit-identical shim over it).

Targets are plain dataclasses: :class:`JobTarget` (an
``AppProfile`` + total work units — the simulator's case) and
:class:`ModelTarget` (a model config + ``max_len`` — the serving case).
Passing ``probes`` (measured ``(x, y)`` pairs) calibrates from them
instead of measuring through the target.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Type, Union

import numpy as np

from repro_torch.core import experts
from repro_torch.sched.elastic import SlowdownCurve, fit_slowdown_curve
from repro_torch.core.experts import MemoryFunction
from repro_torch.sched.resources import DemandModel

if TYPE_CHECKING:
    from repro_torch.core.workloads import AppProfile

#: Aux-axis fit quality worse than this relative error maps to zero
#: confidence (linear in between) — a heuristic scale, not a gate.
_AUX_ERR_SCALE = 0.25


# ---------------------------------------------------------------------------
# Targets and the estimate
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class JobTarget:
    """A schedulable job: which application, how much work, and which
    axis its primary (calibrated) memory curve budgets."""
    app: "AppProfile"
    units: float                      # total work (M-items / k-tokens)
    primary_axis: str = "host_ram"
    #: owning tenant for fairness accounting (None = untenanted)
    tenant: Optional[str] = None


@dataclass(frozen=True)
class ModelTarget:
    """A serving deployment: model config + context length, plus the
    per-request side-car intensities the deployment declares.
    ``page_size`` is the KV allocation granularity in tokens (1 = dense
    slot-per-token; > 1 = the paged backend's page quantum, which the
    estimate exposes so admission books page-rounded demand)."""
    cfg: object
    max_len: int
    host_ram_per_req_gb: float = 0.0  # pinned host staging per request
    net_gbps_per_req: float = 0.0     # egress/interconnect per request
    page_size: int = 1                # KV allocation granularity
    #: measured (bytes GB, duration s) pairs from completed topology
    #: Transmissions (``Topology.net_probes()``); >= 2 points replace
    #: the declared net_gbps_per_req constant with a fitted curve
    net_probes: Optional[Tuple[Tuple[float, float], ...]] = None


Target = Union[JobTarget, ModelTarget]


@dataclass(frozen=True)
class DemandEstimate:
    """What an estimator hands the admission controller: the full
    multi-axis demand model, how much to trust each axis, and whether
    the scheduler should fall back to conservative budget shading."""
    model: DemandModel
    confidence: Dict[str, float] = field(default_factory=dict)  # per axis
    conservative: bool = False
    info: Dict = field(default_factory=dict)
    #: demand-vs-slowdown trade-off along the primary memory axis
    #: (spill-aware shrink admission).  ``None`` or the flat curve both
    #: mean "not shrinkable" — the conservative fallback; estimators fit
    #: it from the same probes the demand curve came from.
    shrink: Optional[SlowdownCurve] = None

    @property
    def primary_fn(self) -> Optional[MemoryFunction]:
        return self.model.primary_fn

    def aux_curves(self) -> Dict[str, MemoryFunction]:
        """Every predicted curve except the primary one."""
        return {a: fn for a, fn in self.model.curves.items()
                if a != self.model.primary_axis}


# ---------------------------------------------------------------------------
# Protocol + registry (mirrors repro_torch.sched.placement)
# ---------------------------------------------------------------------------

class DemandEstimator:
    """Estimation protocol.  Subclass + ``@register_estimator(name)``.

    ``estimate`` must be deterministic given ``(target, probes, rng)``;
    any measurement noise comes from the ``rng`` the caller passes, so
    seeded runs stay reproducible."""

    name = "base"
    #: expert families this estimator fits against (OnlineRefresher
    #: reads this off the registry handle)
    families: Sequence[str] = experts.FAMILIES
    #: whether partial_update folds observations in (vs dropping them)
    supports_online_update = False

    def estimate(self, target: Target,
                 probes: Optional[Sequence[Tuple[float, float]]] = None,
                 *, rng: Optional[np.random.Generator] = None
                 ) -> DemandEstimate:
        raise NotImplementedError

    def partial_update(self, features: np.ndarray, family: str) -> bool:
        """Online refresh hook: fold one profiled observation into the
        estimator.  Estimators that do not learn online drop the
        observation (return False) instead of raising, so the refresher
        can stream into any registry handle."""
        return False


_REGISTRY: Dict[str, Type[DemandEstimator]] = {}


def register_estimator(name: str):
    """Class decorator adding an estimator to the registry."""
    def deco(cls: Type[DemandEstimator]) -> Type[DemandEstimator]:
        if not issubclass(cls, DemandEstimator):
            raise TypeError(f"{cls!r} is not a DemandEstimator")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_estimator(name: str, **kwargs) -> DemandEstimator:
    """Instantiate the registered estimator ``name``.  ``kwargs`` are
    forwarded to the constructor (every job estimator accepts a
    ``predictor=`` keyword, used or ignored as appropriate, so sweeps
    can construct any of them uniformly)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown estimator {name!r} "
                       f"(available: {available_estimators()})") from None
    return cls(**kwargs)


def available_estimators() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


#: Estimators a config-level sweep (``SimConfig.estimator`` /
#: ``benchmarks/run.py --estimator``) can instantiate around whatever
#: predictor the swept policy happens to carry.  ``ann`` needs a fitted
#: ANNPredictor passed explicitly and ``kv-growth`` only estimates
#: serving ModelTargets, so neither is sweepable.
SWEEPABLE_ESTIMATORS = ("moe", "oracle", "single-family", "conservative")


def resolve_estimator(spec, predictor=None) -> Optional[DemandEstimator]:
    """The consumer-side resolution rule: an estimator instance passes
    through; a registry name is instantiated around ``predictor``; an
    empty spec wraps the predictor in its faithful estimator (the
    back-compat default — bit-identical to the pre-estimator paths)."""
    if isinstance(spec, DemandEstimator):
        return spec
    if spec:
        return get_estimator(spec, predictor=predictor)
    return wrap_predictor(predictor)


def wrap_predictor(predictor) -> Optional[DemandEstimator]:
    """Adapt a fitted ``repro_torch.core.predictor`` object to the estimator
    API (the migration shim: ``OursPolicy(moe)`` keeps working and keeps
    its exact RNG draw order)."""
    if predictor is None:
        return None
    if isinstance(predictor, DemandEstimator):
        return predictor
    from repro_torch.core.predictor import (ANNPredictor, OraclePredictor,
                                      UnifiedFamilyPredictor)
    if isinstance(predictor, OraclePredictor):
        return OracleEstimator()
    if isinstance(predictor, UnifiedFamilyPredictor):
        return SingleFamilyEstimator(family=predictor.family)
    if isinstance(predictor, ANNPredictor):
        return ANNEstimator(predictor=predictor)
    if hasattr(predictor, "select_family"):
        return MoEEstimator(predictor=predictor)
    if hasattr(predictor, "predict_function"):
        return PredictorEstimator(predictor=predictor)
    raise TypeError(f"cannot adapt {type(predictor).__name__} to the "
                    f"DemandEstimator API")


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _fit_probes(family: str,
                probes: Sequence[Tuple[float, float]]) -> MemoryFunction:
    """Instantiate (m, b) from measured probes: the paper's exact
    two-point solve for two, least-squares beyond."""
    pts = sorted((float(x), float(y)) for x, y in probes)
    if len(pts) < 2:
        raise ValueError("calibration needs at least two probes")
    if len(pts) == 2:
        (x1, y1), (x2, y2) = pts
        return experts.calibrate_two_point(family, x1, y1, x2, y2)
    xs, ys = zip(*pts)
    return experts.fit(family, xs, ys)


def _two_point_best(xs: np.ndarray, ys: np.ndarray,
                    families: Sequence[str]
                    ) -> Tuple[MemoryFunction, float]:
    """The paper's calibration style applied to family selection:
    two-point-solve each candidate family through the end probes and
    keep the one whose RELATIVE error over all probes is smallest.
    (Least-squares fits minimize absolute residuals, which lets a
    power fit beat an exact affine curve whose small probe it crushes.)"""
    best_fn, best_err = None, np.inf
    for fam in families:
        try:
            fn = experts.calibrate_two_point(
                fam, float(xs[0]), float(ys[0]),
                float(xs[-1]), float(ys[-1]))
        except (ValueError, AssertionError):
            continue
        err = experts.relative_error(fn, xs, ys)
        if err < best_err:
            best_fn, best_err = fn, err
    if best_fn is None:                      # degenerate probes
        best_fn = experts.fit("affine", xs, ys)
        best_err = experts.relative_error(best_fn, xs, ys)
    return best_fn, float(best_err)


def predict_aux_curves(app: "AppProfile", xs: np.ndarray,
                       rng: Optional[np.random.Generator],
                       families: Sequence[str] = experts.FAMILIES,
                       skip: Tuple[str, ...] = ()
                       ) -> Tuple[Dict[str, MemoryFunction],
                                  Dict[str, float], Dict]:
    """PREDICT the side-car demand curves: probe each aux axis the
    workload exposes at the same calibration sizes as the primary curve
    and two-point-calibrate it.  ``net`` gets the simple linear
    contention curve (affine: bandwidth scales with the split); other
    axes pick the candidate family with the best relative probe fit.
    This replaces reading declared ``AppProfile.aux_demand`` curves
    straight into admission."""
    curves: Dict[str, MemoryFunction] = {}
    conf: Dict[str, float] = {}
    calib: Dict[str, List] = {}
    for axis in sorted(getattr(app, "aux_demand", {}) or {}):
        if axis in skip:
            continue
        ys = np.asarray([app.measure_axis(axis, float(x), rng)
                         for x in xs])
        if axis == "net":
            fn, err = _two_point_best(xs, ys, ("affine",))
        else:
            fn, err = _two_point_best(xs, ys, families)
        curves[axis] = fn
        conf[axis] = float(np.clip(1.0 - err / _AUX_ERR_SCALE, 0.0, 1.0))
        calib[axis] = list(zip(xs.tolist(), ys.tolist()))
    return curves, conf, calib


def _job_estimate(primary_fn: MemoryFunction, target: JobTarget,
                  xs: np.ndarray, rng, info: Dict,
                  primary_conf: float, conservative: bool,
                  families: Sequence[str] = experts.FAMILIES
                  ) -> DemandEstimate:
    """Assemble the multi-axis estimate: primary curve + predicted aux
    curves (probed AFTER the primary calibration, so workloads without
    aux axes keep the exact pre-estimator RNG stream)."""
    aux, aux_conf, aux_calib = predict_aux_curves(
        target.app, xs, rng, families, skip=(target.primary_axis,))
    curves = {target.primary_axis: primary_fn}
    curves.update(aux)
    conf = {target.primary_axis: primary_conf}
    conf.update(aux_conf)
    if aux_calib:
        info = {**info, "aux_calib": aux_calib,
                "aux_families": {a: fn.family for a, fn in aux.items()}}
    model = DemandModel(curves, primary_axis=target.primary_axis)
    # the demand-vs-slowdown curve rides the SAME calibrated primary
    # fit (no extra probes, no RNG draws); a conservative estimate is
    # never shrinkable — flat curve
    shrink = (SlowdownCurve.flat() if conservative
              else fit_slowdown_curve(primary_fn, target.units))
    return DemandEstimate(model, conf, conservative, info, shrink=shrink)


# ---------------------------------------------------------------------------
# Serving footprint calibration (owned by KVGrowthEstimator)
# ---------------------------------------------------------------------------

#: (config name, max_len) -> calibrated affine footprint-vs-batch fit.
#: The fit only depends on the abstract parameter/cache shapes, so
#: reuse is exact; ``refit=True`` bypasses (e.g. after editing a config
#: in-process).
_FOOTPRINT_CACHE: Dict[Tuple[str, int], MemoryFunction] = {}


def calibrate_model_footprint(cfg, max_len: int, *,
                              refit: bool = False) -> MemoryFunction:
    """Probe the model's abstract weights + KV cache at batch 2 and 4
    and two-point-solve the affine footprint-vs-batch curve (intercept =
    weights GB, slope = KV GB per request at ``max_len``), cached per
    ``(config name, max_len)`` with a one-line reused-vs-refit note."""
    # runtime-only imports: repro_torch.sched must stay loadable before
    # repro_torch.models
    from repro_torch.models import model as model_lib
    from repro_torch.utils.tree import tree_bytes

    key = (getattr(cfg, "name", repr(cfg)), int(max_len))
    fn = None if refit else _FOOTPRINT_CACHE.get(key)
    if fn is None:
        def fp(batch: int) -> float:
            w = tree_bytes(model_lib.abstract(cfg))
            c = model_lib.init_cache(cfg, batch, int(max_len),
                                     abstract_only=True)
            return (w + tree_bytes(c)) / 2 ** 30
        fn = experts.calibrate_two_point("affine", 2, fp(2), 4, fp(4))
        _FOOTPRINT_CACHE[key] = fn
        print(f"footprint calibration: fit {key[0]}@{max_len} "
              f"(weights {fn.m:.4f} GB + {fn.b:.5f} GB/slot)")
    else:
        print(f"footprint calibration: reused cached fit for "
              f"{key[0]}@{max_len}")
    return fn


def _measured_net_curve(net_probes) -> Tuple[Optional[float],
                                             Optional[Dict]]:
    """Learn the per-request net intensity from observed Transmission
    completions: fit duration-vs-bytes over the measured ``(gb, s)``
    probes with the SAME two-point family selection the aux axes use
    (the affine truth — link latency intercept + inverse-bandwidth
    slope — wins on clean data, but congested traces may genuinely
    curve), then read off the effective GB/s one in-flight request
    sustains at the mean observed transfer size.  Returns
    ``(confidence, info)`` — ``(None, None)`` when the probes cannot
    support a fit (fewer than two distinct sizes, degenerate fit)."""
    if not net_probes:
        return None, None
    pts = sorted({(float(x), float(y)) for x, y in net_probes
                  if float(x) > 0.0 and float(y) > 0.0})
    if len(pts) < 2 or pts[0][0] >= pts[-1][0]:
        return None, None
    xs = np.asarray([x for x, _ in pts])
    ys = np.asarray([y for _, y in pts])
    fit, err = _two_point_best(xs, ys, experts.FAMILIES)
    mean_gb = float(np.mean(xs))
    dur = float(fit(mean_gb))
    if dur <= 0.0:
        return None, None
    conf = float(np.clip(1.0 - err / _AUX_ERR_SCALE, 0.0, 1.0))
    return conf, {"family": fit.family,
                  "gbps_per_req": mean_gb / dur,
                  "err": float(err), "n_probes": len(pts)}


def _model_estimate(target: ModelTarget, *, pad: float = 1.0,
                    conservative: bool = False,
                    refit: bool = False,
                    probes: Optional[Sequence[Tuple[float, float]]] = None
                    ) -> DemandEstimate:
    """The serving demand model: the calibrated (or probe-supplied)
    affine footprint on ``hbm``, plus per-request side-car axes.  ``pad``
    inflates the KV slope and the side-cars (the conservative serving
    policy books headroom for the uncertain, growing parts; the weights
    intercept is exact and stays put)."""
    if probes is not None:
        fn = _fit_probes("affine", probes)
    else:
        fn = calibrate_model_footprint(target.cfg, target.max_len,
                                       refit=refit)
    if pad != 1.0:
        fn = MemoryFunction("affine", fn.m, fn.b * pad)
    curves: Dict[str, MemoryFunction] = {"hbm": fn}
    if target.host_ram_per_req_gb > 0.0:
        curves["host_ram"] = MemoryFunction(
            "affine", 0.0, float(target.host_ram_per_req_gb) * pad)
    if target.net_gbps_per_req > 0.0:
        # linear contention: egress bandwidth scales with in-flight
        # requests (unpadded — an average-rate axis, not OOM-able)
        curves["net"] = MemoryFunction(
            "affine", 0.0, float(target.net_gbps_per_req))
    net_conf, net_info = _measured_net_curve(
        getattr(target, "net_probes", None))
    if net_info is not None:
        curves["net"] = MemoryFunction(
            "affine", 0.0, net_info["gbps_per_req"])
    conf = {a: (0.0 if conservative else 1.0) for a in curves}
    if net_conf is not None:
        conf["net"] = net_conf        # measured, not declared
    info = {"family": "affine", "max_len": int(target.max_len),
            "pad": pad,
            "page_size": int(getattr(target, "page_size", 1))}
    if net_info is not None:
        info["net_measured"] = net_info
    # serving shrink: a request can join on a fraction of its KV
    # reservation, paying recompute/spill overhead per decode step —
    # the weights intercept is not shrinkable, so the declared linear
    # price covers only the growing KV share.  Conservative -> flat.
    shrink = (SlowdownCurve.flat() if conservative
              else SlowdownCurve.linear(1.6, min_fraction=0.5))
    return DemandEstimate(DemandModel(curves, primary_axis="hbm"),
                          conf, conservative, info, shrink=shrink)


# ---------------------------------------------------------------------------
# Implementations
# ---------------------------------------------------------------------------

@register_estimator("moe")
class MoEEstimator(DemandEstimator):
    """The flagship: wraps a fitted
    :class:`~repro_torch.core.predictor.MoEPredictor`.  Primary curve via the
    paper's select -> two-point-calibrate runtime path (identical RNG
    draw order — the pre-estimator results are pinned bit-identical);
    side-car axes *predicted* from profiled aux probes."""

    supports_online_update = True

    def __init__(self, predictor=None):
        if predictor is None or not hasattr(predictor, "select_family"):
            raise ValueError("the moe estimator wraps a fitted "
                             "MoEPredictor — pass predictor=")
        self.predictor = predictor

    @property
    def families(self):
        return self.predictor.families

    def select_family(self, features):
        return self.predictor.select_family(features)

    def partial_update(self, features, family) -> bool:
        return self.predictor.partial_update(features, family)

    def estimate(self, target, probes=None, *, rng=None):
        if isinstance(target, ModelTarget):
            return _model_estimate(target, probes=probes)
        from repro_torch.core.predictor import calibration_points
        app = target.app
        if probes is not None:
            fam, dist, confident = self.predictor.select_family(
                app.features)
            fn = _fit_probes(fam, probes)
            xs = np.asarray(sorted(float(x) for x, _ in probes))
            info = {"family": fam, "distance": dist,
                    "confident": confident,
                    "calib": [list(p) for p in probes]}
        else:
            fn, info = self.predictor.predict_function(
                app, target.units, rng)
            confident = bool(info.get("confident", True))
            dist = float(info.get("distance", 0.0))
            xs = calibration_points(target.units)
        fb = max(getattr(self.predictor, "fallback_distance", 0.35),
                 1e-9)
        conf = float(np.clip(1.0 - dist / fb, 0.0, 1.0))
        return _job_estimate(fn, target, xs, rng, info, conf,
                             conservative=not confident,
                             families=self.predictor.families)


@register_estimator("oracle")
class OracleEstimator(DemandEstimator):
    """Prophetic: ground-truth curves on EVERY axis, no probing cost,
    confidence 1.0.  The schedule-dynamics-matched upper bound."""

    def __init__(self, predictor=None):
        pass                              # nothing to wrap

    def estimate(self, target, probes=None, *, rng=None):
        if isinstance(target, ModelTarget):
            return _model_estimate(target, probes=probes)
        app = target.app
        curves = {target.primary_axis: app.true_fn}
        for axis, fn in sorted((app.aux_demand or {}).items()):
            if axis != target.primary_axis:
                curves[axis] = fn
        conf = {a: 1.0 for a in curves}
        model = DemandModel(curves, primary_axis=target.primary_axis)
        return DemandEstimate(model, conf, False,
                              {"family": app.family, "oracle": True},
                              shrink=fit_slowdown_curve(app.true_fn,
                                                        target.units))


@register_estimator("single-family")
class SingleFamilyEstimator(DemandEstimator):
    """Fig. 9 baseline: ONE expert family for every application and
    every axis, calibrated on the 5%/10% probes (bit-identical to
    :class:`~repro_torch.core.predictor.UnifiedFamilyPredictor`)."""

    def __init__(self, family: str = "power", predictor=None):
        if predictor is not None and hasattr(predictor, "family"):
            family = predictor.family
        if family not in experts.FAMILIES:
            raise ValueError(f"unknown family {family!r}")
        self.family = family
        self.families = (family,)

    def estimate(self, target, probes=None, *, rng=None):
        if isinstance(target, ModelTarget):
            return _model_estimate(target, probes=probes)
        app = target.app
        if probes is not None:
            fn = _fit_probes(self.family, probes)
            xs = np.asarray(sorted(float(x) for x, _ in probes))
        else:
            x1, x2 = 0.05 * target.units, 0.10 * target.units
            y1, y2 = app.measure(x1, rng), app.measure(x2, rng)
            fn = experts.calibrate_two_point(self.family, x1, y1, x2, y2)
            xs = np.asarray([x1, x2])
        return _job_estimate(fn, target, xs, rng,
                             {"family": self.family}, 0.5, False,
                             families=self.families)


@register_estimator("ann")
class ANNEstimator(DemandEstimator):
    """QUASAR-style monolithic baseline: wraps a fitted
    :class:`~repro_torch.core.predictor.ANNPredictor` (one regressor over
    (features, x) -> y); aux axes probed + best-family fitted."""

    def __init__(self, predictor=None):
        if predictor is None or not hasattr(predictor, "_predict_log_y"):
            raise ValueError("the ann estimator wraps a fitted "
                             "ANNPredictor — pass predictor=")
        self.predictor = predictor

    def estimate(self, target, probes=None, *, rng=None):
        if isinstance(target, ModelTarget):
            return _model_estimate(target, probes=probes)
        from repro_torch.core.predictor import calibration_points
        fn, info = self.predictor.predict_function(
            target.app, target.units, rng)
        xs = calibration_points(target.units)
        # a monolithic net carries no usable confidence signal
        return _job_estimate(fn, target, xs, rng, info, 0.5, False)


@register_estimator("conservative")
class ConservativeEstimator(DemandEstimator):
    """No learned selector: fit the probe curve with whichever family
    explains it best and ALWAYS flag the estimate conservative, so the
    scheduler applies its low-confidence shading (halved memory budgets,
    paper Section 6.9).  On serving targets there is no shading hook in
    the batcher, so the footprint's growing parts are padded by
    ``pad`` instead."""

    def __init__(self, predictor=None, pad: float = 1.25):
        self.pad = float(pad)

    def estimate(self, target, probes=None, *, rng=None):
        if isinstance(target, ModelTarget):
            return _model_estimate(target, pad=self.pad,
                                   conservative=True, probes=probes)
        from repro_torch.core.predictor import calibration_points
        app = target.app
        if probes is not None:
            xs = np.asarray(sorted(float(x) for x, _ in probes))
            ys = np.asarray([y for _, y in
                             sorted((float(x), float(y))
                                    for x, y in probes)])
        else:
            xs = calibration_points(target.units)
            ys = np.asarray([app.measure(float(x), rng) for x in xs])
        fn, errs = experts.best_family(xs, ys, self.families)
        info = {"family": fn.family, "confident": False,
                "fit_errors": errs,
                "calib": list(zip(xs.tolist(), ys.tolist()))}
        return _job_estimate(fn, target, xs, rng, info, 0.0, True)


@register_estimator("kv-growth")
class KVGrowthEstimator(DemandEstimator):
    """The serving footprint estimator: owns the per-``(config,
    max_len)`` two-point affine calibration cache.
    ``DemandModel.from_model_config`` is now a deprecated shim over this
    (bit-identical: same cache, same curves)."""

    def __init__(self, predictor=None, refit: bool = False):
        self.refit = bool(refit)

    def estimate(self, target, probes=None, *, rng=None):
        if not isinstance(target, ModelTarget):
            raise TypeError("kv-growth estimates serving ModelTargets; "
                            "use moe/oracle/... for job targets")
        return _model_estimate(target, refit=self.refit, probes=probes)


class PredictorEstimator(DemandEstimator):
    """Last-resort adapter for any duck-typed ``predict_function``
    object (custom predictors keep working through the estimator API)."""

    name = "predictor"

    def __init__(self, predictor=None):
        if predictor is None:
            raise ValueError("pass predictor=")
        self.predictor = predictor

    def estimate(self, target, probes=None, *, rng=None):
        from repro_torch.core.predictor import calibration_points
        fn, info = self.predictor.predict_function(
            target.app, target.units, rng)
        xs = calibration_points(target.units)
        conservative = not info.get("confident", True)
        return _job_estimate(fn, target, xs, rng, info,
                             0.0 if conservative else 0.5, conservative)
