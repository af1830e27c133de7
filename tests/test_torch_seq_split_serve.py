"""The sharded serving steps (``repro_torch.train.sharded_serve``) over 4
gloo ranks on a (1, 4) (data, model) mesh, where the smoke configs' 2 kv
heads do not split over 4 model ranks and ``cache_specs`` splits the KV
cache over the sequence: each rank holds every kv head of its 4 of the
16 slots, writes the decode token only where it owns the slot, gathers
the q heads and merges the ranks' partial attention by the log-sum-exp.
The prefill of 4 rows x 8 tokens and 4 greedy serve steps (which cross
from rank 1's slots into rank 2's and 3's) of qwen3-0.6b, gemma2-27b
(window 8: ranges fall out of the local layers' window), pixtral-12b,
qwen3-moe (capacity 4.0, nothing drops), whisper with 2 kv heads (its
cross-attention cache of 4 frames split over the sequence too), qwen3
with 6 q heads (``wq`` whole: no q gather, the partials all-gathered)
and qwen3 with an 18-slot cache, which 4 does not divide (``fix_spec``
leaves it whole), in f32: each against the port's one-rank
``build_prefill_step`` / ``build_serve_step`` and against the JAX
dry-run's steps jitted under ``serve_shardings`` on 4 host devices:
tokens equal, the prefill's logits and every gathered cache leaf within
1e-5.  One spawn of the ranks and one JAX process serve the file."""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import save
from repro_torch.train.step import build_prefill_step, build_serve_step

sys.path.insert(0, os.path.dirname(__file__))
import scaleout_ranks  # noqa: E402

torch.set_num_threads(1)
B, S, MAX_LEN, STEPS, M = 4, 8, 16, 4, 4
MOE = "qwen3-moe-30b-a3b"
#: (run id, arch, config overrides, cache slots)
RUNS = [("qwen3-0.6b", "qwen3-0.6b", {}, MAX_LEN),
        ("gemma2-27b", "gemma2-27b", {}, MAX_LEN),
        ("pixtral-12b", "pixtral-12b", {}, MAX_LEN),
        (MOE, MOE, {"capacity_factor": 4.0}, MAX_LEN),
        ("whisper-hkv2", "whisper-large-v3", {"num_kv_heads": 2}, MAX_LEN),
        ("qwen3-hq6", "qwen3-0.6b", {"num_heads": 6}, MAX_LEN),
        ("qwen3-whole", "qwen3-0.6b", {}, 18)]
IDS = [r[0] for r in RUNS]
TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_split")
    inp = {"archs": np.array(IDS), "max_len": MAX_LEN, "steps": STEPS,
           "mesh": np.array([1, M])}
    for rid, arch, over, ml in RUNS:
        _, params, batch = scaleout_ranks.serve_inputs(arch, over, B, S)
        save(str(tmp / f"ckpt_{rid}"), 0, params)
        inp.update({f"{rid}/ckpt": str(tmp / f"ckpt_{rid}"),
                    f"{rid}/arch": arch, f"{rid}/max_len": ml})
        inp.update({f"{rid}/{k}": v.numpy() for k, v in batch.items()})
        inp.update({f"{rid}/{k}": v for k, v in over.items()})
    np.savez(tmp / "in.npz", **inp)
    proc = scaleout_ranks.jax_process("serve_steps", tmp / "in.npz",
                                      tmp / "jax.npz")
    try:
        ranks = scaleout_ranks.spawn(
            "tp_serve_rank", tmp, (1, M), [r[1:] for r in RUNS], B, S,
            MAX_LEN, STEPS)
    finally:
        ref = scaleout_ranks.jax_result(proc, tmp / "jax.npz")
    return ranks, ref


def one_rank(arch, over, max_len):
    cfg, params, batch = scaleout_ranks.serve_inputs(arch, over, B, S)
    logits, cache = build_prefill_step(cfg, max_len)(params, batch)
    tok = torch.argmax(logits, -1).to(torch.int32)
    toks, serve = [tok], build_serve_step(cfg)
    for _ in range(STEPS):
        tok, cache = serve(params, tok, cache)
        toks.append(tok)
    return cfg, toks, logits, cache


def _served(ranks, i):
    got = [r[i] for r in ranks]
    for g in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(g["tokens"],
                                                     got[0]["tokens"]))
    return got


@pytest.mark.parametrize("i", range(len(RUNS)), ids=IDS)
def test_sequence_split_serving_equals_one_rank(runs, i):
    ranks, _ = runs
    rid, arch, over, ml = RUNS[i]
    got = _served(ranks, i)[0]
    _, toks, logits, cache = one_rank(arch, over, ml)
    for a, b in zip(got["tokens"], toks, strict=True):
        assert torch.equal(a, b), (rid, a, b)
    assert float((got["logits"] - logits).abs().max()) <= TOL
    assert set(got["cache"]) == set(cache)
    for k, v in cache.items():
        d = float((got["cache"][k].float() - v.float()).abs().max())
        assert d <= TOL, (rid, k, d)


@pytest.mark.parametrize("i", range(len(RUNS)), ids=IDS)
def test_sequence_split_serving_equals_jax_serve_shardings(runs, i):
    ranks, ref = runs
    rid = RUNS[i][0]
    got = _served(ranks, i)[0]
    for j, a in enumerate(got["tokens"]):
        assert np.array_equal(a.numpy(), ref[f"{rid}/tok{j}"]), (rid, j)
    assert np.abs(got["logits"].numpy() - ref[f"{rid}/logits"]).max() \
        <= TOL
    for k, v in got["cache"].items():
        want = ref[f"{rid}/cache/{k}"]
        assert v.shape == want.shape, (rid, k)
        d = np.abs(v.float().numpy() - want.astype(np.float32)).max()
        assert d <= TOL, (rid, k, d)


@pytest.mark.parametrize("i", range(len(RUNS)), ids=IDS)
def test_each_rank_holds_its_slot_range_or_the_whole_cache(runs, i):
    """[L, B, S/4, Hkv, hd] blocks of every KV leaf (whisper's cross
    cache too) where JAX's ``cache_specs`` split the sequence, the whole
    leaf where it left it whole (18 slots)."""
    ranks, ref = runs
    rid, _, _, ml = RUNS[i]
    for r in _served(ranks, i):
        for k, shape in r["local"].items():
            whole = r["cache"][k].shape
            if k == "len":
                continue
            spec = str(ref[f"{rid}/spec/{k}"])
            if ml % M:
                assert "model" not in spec and shape == tuple(whole), (k,
                                                                       spec)
            else:
                assert spec.endswith("'model', None, None)"), (rid, k,
                                                                spec)
                assert shape == (whole[0], whole[1], whole[2] // M,
                                 *whole[3:]), (rid, k, shape)


def test_a_split_decode_step_adds_a_q_gather_and_one_exchange_per_layer(
        runs):
    """qwen3 on (1, 4), one serve step: per layer one all-gather of the q
    heads and one all-to-all of the partials (o, lse), and nothing else
    beside what the whole cache's step issues (the all-reduces of the
    split blocks, the vocabulary's, and one all-gather of each stacked
    leaf computed whole: ``wk``, ``wv``).  With ``wq`` whole (6 q heads)
    no q gather and no all-to-all: the partials are all-gathered, beside
    the gathers of ``wq`` and ``wo``."""
    ranks, _ = runs
    split = _served(ranks, IDS.index("qwen3-0.6b"))[0]["collectives"]
    whole_q = _served(ranks, IDS.index("qwen3-hq6"))[0]["collectives"]
    whole = _served(ranks, IDS.index("qwen3-whole"))[0]["collectives"]
    L = scaleout_ranks.serve_inputs("qwen3-0.6b", {}, B, S)[0].num_layers
    assert whole == {"all-gather": 2, "all-reduce": 2 * L + 3}, whole
    assert split == {"all-gather": 2 + L, "all-to-all": L,
                     "all-reduce": 2 * L + 3}, split
    assert whole_q == {"all-gather": 4 + L, "all-reduce": L + 3}, whole_q
