"""The JAX package's own properties of the feature probe
(``tests/test_features.py``), held by the port's
``repro_torch.core.features``: 22 finite values for the train and the
serve step, the record's features exact (and equal to the JAX
function's), and dense vs SSM and dense vs MoE vectors farther apart than
1.0, the property the KNN expert selector relies on (``slow`` in the JAX
package, where each probe compiles; here each runs in about a second, so
it is in the fast tier).  And a full-size probe: kimi-k2-1t-a32b's decode
step, about 2 TB of weights, probed without allocating them."""
import numpy as np
import pytest
import torch

from repro.core import features as jf
from repro_torch.configs import get_config, input_specs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.features import (TPU_FEATURE_NAMES, extract_features,
                                       features_from_record, probe_record)

torch.set_num_threads(1)


def test_feature_vector_shape_and_finiteness():
    cfg = get_config("qwen3-0.6b", smoke=True)
    f = extract_features(cfg, "train", probe_seq=32, probe_batch=2)
    assert f.shape == (22,)
    assert np.all(np.isfinite(f))
    assert len(TPU_FEATURE_NAMES) == 22


def test_features_separate_architecture_families():
    dense = extract_features(get_config("qwen3-0.6b", smoke=True),
                             "train", 32, 2)
    ssm = extract_features(get_config("mamba2-780m", smoke=True),
                           "train", 32, 2)
    moe = extract_features(get_config("qwen3-moe-30b-a3b", smoke=True),
                           "train", 32, 2)
    assert np.linalg.norm(dense - ssm) > 1.0
    assert np.linalg.norm(dense - moe) > 1.0


def test_features_from_dryrun_record():
    rec = {
        "roofline": {"compute_s": 1.0, "memory_s": 3.0,
                     "collective_s": 1.0},
        "cost": {"flops_per_device": 1e12, "hbm_bytes_per_device": 1e10},
        "memory": {"argument_bytes": 2 ** 30, "temp_bytes": 2 ** 32,
                   "output_bytes": 2 ** 30},
        "collectives": {"total_bytes": 1e9,
                        "bytes": {"all-reduce": 8e8, "all-gather": 2e8},
                        "counts": {"all-reduce": 10, "all-gather": 4}},
        "hlo_ops": {"dot": 30, "fusion": 100, "while": 2},
        "loops": [{"trip": 24}, {"trip": 24}],
        "params_total": 1e9,
        "tokens": 4096,
    }
    f = features_from_record(rec)
    names = dict(zip(TPU_FEATURE_NAMES, f))
    assert abs(names["log_flops"] - 12.0) < 1e-6
    assert abs(names["coll_allreduce_frac"] - 0.8) < 1e-6
    assert names["loop_trip_mean"] == 24.0
    assert abs(names["memory_term_share"] - 0.6) < 1e-6
    np.testing.assert_array_equal(f, jf.features_from_record(rec))
    assert TPU_FEATURE_NAMES == jf.TPU_FEATURE_NAMES


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_extract_both_step_kinds(kind):
    cfg = get_config("qwen3-0.6b", smoke=True)
    f = extract_features(cfg, kind, probe_seq=32, probe_batch=2)
    assert np.all(np.isfinite(f))


def test_full_size_probe_allocates_nothing():
    """kimi-k2-1t-a32b at full width and depth: 1.04 T parameters, whose
    bf16 weights alone (2.08 TB) could not be allocated on any one
    machine that runs this test.  The probe reads them all as arguments,
    exactly the abstract tree's bytes and the inputs', and returns 22
    finite values."""
    from repro_torch.models import model as model_lib
    from repro_torch.utils.tree import tree_bytes
    cfg = get_config("kimi-k2-1t-a32b")
    rec = probe_record(cfg, "decode")
    specs = input_specs(cfg, ShapeConfig("probe", "decode", 64, 2))
    want = tree_bytes(model_lib.abstract(cfg)) + tree_bytes(specs)
    assert rec["memory"]["argument_bytes"] == want > 2e12
    assert rec["params_total"] > 1e12
    assert np.all(np.isfinite(features_from_record(rec)))
