"""``repro_torch.tools.serving_demo`` on the CPU against the JAX
package's ``examples/serving_demo.py``: the engine's summary (completed,
steps, join points, preemptions, forced steps) equals the JAX demo's (run
as its own process), and, in f32 with the JAX backend's weights carried
across (``from_jax``), each request's token stream equals the JAX demo's
loop over ``JaxBackend``."""
import os
import re
import subprocess
import sys

import jax
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.sched import ModelTarget as JModelTarget
from repro.sched import ResourceVector as JResourceVector
from repro.sched import get_estimator as j_get_estimator
from repro.serve import Engine as JEngine
from repro.serve import JaxBackend
from repro.serve import Request as JRequest
from repro.serve import ServingDemand as JServingDemand
from repro_torch.configs import get_config
from repro_torch.models.params import from_jax
from repro_torch.tools import serving_demo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: f32 under a name of its own: the kv-growth estimator caches its
#: calibration by (config name, max_len), and the bf16 config's is not
#: this one's
F32 = dict(param_dtype="float32", compute_dtype="float32",
           name="qwen3-0.6b-smoke-f32")
SERVED = re.compile(r"served (\d+) requests across (\d+) steps \((\d+) join "
                    r"points, (\d+) preemptions\)")


def _summary(s, joins):
    return (s["completed"], s["steps"], joins, s["preemptions"],
            s["forced_steps"])


def test_summary_equals_jax_demo(capsys):
    proc = subprocess.Popen(
        [sys.executable, os.path.join("examples", "serving_demo.py")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                           JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = serving_demo.main(["--device", "cpu"])
    jout, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    completed, steps, joins, pre = map(int, SERVED.search(jout).groups())
    forced = int(re.search(r"\| forced (\d+) \|", jout).group(1))
    assert _summary(out["summary"], out["joins"]) == \
        (completed, steps, joins, pre, forced)
    assert completed == 12
    mine = capsys.readouterr().out
    # the printed calibration and budget lines are the JAX demo's
    assert mine.splitlines()[:3] == jout.splitlines()[:3]


def test_token_streams_equal_jax_with_its_weights():
    args = serving_demo.parser().parse_args(["--device", "cpu"])
    jcfg = j_get_config("qwen3-0.6b", smoke=True).replace(**F32)
    jp = jm.init(jcfg, jax.random.key(0))
    # the JAX demo's loop, over JaxBackend with these weights
    estimate = j_get_estimator("kv-growth").estimate(
        JModelTarget(jcfg, args.max_len))
    demand = JServingDemand.from_estimate(estimate, args.max_len)
    jreqs = [JRequest(rid=r.rid, prompt_len=r.prompt_len,
                      max_new_tokens=r.max_new_tokens, arrival=r.arrival)
             for r in serving_demo.requests(args.requests,
                                            args.decode_steps)]
    jeng = JEngine(jreqs, demand, JResourceVector(hbm=args.budget_gb),
                   JaxBackend(jcfg, params=jp, max_len=args.max_len),
                   mode=args.mode, max_batch=16)
    jsum = jeng.run()
    out = serving_demo.serve(
        args, get_config("qwen3-0.6b", smoke=True).replace(**F32),
        params=from_jax(jax.tree.map(np.asarray, jp)))
    jjoins = sum(1 for d in jeng.metrics.steps if d.admitted)
    assert _summary(out["summary"], out["joins"]) == _summary(jsum, jjoins)
    assert [r.rid for r in out["requests"]] == [r.rid for r in jreqs]
    for a, b in zip(out["requests"], jreqs):
        assert len(a.tokens) == a.max_new_tokens
        assert a.tokens == b.tokens, a.rid
