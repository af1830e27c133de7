"""``repro_torch.core.features.extract_features`` on every arch of
``ARCH_IDS`` (smoke configs), for the train and the serve step: 22
finite values each, in fresh processes in which neither ``jax`` nor
anything of the JAX package ``repro`` is ever imported (three at once:
the train step of each half of the archs, the serve step of all)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
#: (step kind, first arch, end): slices of ARCH_IDS
PARTS = [("train", 0, 5), ("train", 5, 10), ("decode", 0, 10)]

CODE = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.features import extract_features
kind, lo, hi = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
bad = []
for arch in ARCH_IDS[lo:hi]:
    f = extract_features(get_config(arch, smoke=True), kind)
    if f.shape != (22,) or not np.all(np.isfinite(f)):
        bad.append((arch, f))
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert not loaded, loaded
print(len(ARCH_IDS[lo:hi]))
"""


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {part: subprocess.Popen(
        [sys.executable, "-c", CODE, *map(str, part)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in PARTS}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[k] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("part", PARTS, ids=lambda p: "%s-%d-%d" % p)
def test_every_arch_gives_22_finite_features_without_jax(runs, part):
    rc, stdout, stderr = runs[part]
    assert rc == 0, stderr[-4000:]
    assert stdout.split() == [str(part[2] - part[1])]
