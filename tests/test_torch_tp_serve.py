"""The sharded serving steps (``repro_torch.train.sharded_serve``) over 4
gloo ranks on a (2, 2) (data, model) mesh: the prefill of 4 rows x 8
tokens into a 16-slot cache and 4 greedy serve steps of each attention
family's smoke config in f32 (qwen3-0.6b, gemma2, whisper, pixtral, and
qwen3-moe at a capacity where nothing drops, also expert-parallel), and
of mamba2 and zamba2, whose Mamba2 layers compute their heads on each
rank (``tests/test_torch_mamba_tp.py`` holds them on both meshes); each
against the
port's one-rank ``build_prefill_step`` / ``build_serve_step`` and the
attention families against the JAX dry-run's steps jitted under
``serve_shardings`` on 4 host devices: tokens equal, the prefill's
logits and every cache leaf (gathered) within 1e-5.  Each rank holds its
rows and heads of the KV cache (the sequence split and the whole cache
on (1, 4): ``tests/test_torch_seq_split_serve.py``).  Then
``models/tp.py``'s helpers on the ranks against their one-rank
formulas, and outside the context as the identity.  One spawn of the
ranks and one JAX process serve the whole file."""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import save
from repro_torch.models import tp
from repro_torch.train.step import build_prefill_step, build_serve_step

sys.path.insert(0, os.path.dirname(__file__))
import scaleout_ranks  # noqa: E402

torch.set_num_threads(1)
B, S, MAX_LEN, STEPS = 4, 8, 16, 4
MOE = "qwen3-moe-30b-a3b"
NO_DROP = {"capacity_factor": 4.0}
ATTENTION = ["qwen3-0.6b", "gemma2-27b", "whisper-large-v3", "pixtral-12b",
             MOE]
#: (arch, config overrides[, cache slots, expert parallelism]): the MoE
#: also with its layers expert-parallel (``moe_ffn_ep`` over 'data', on
#: each rank's expert shards)
RUNS = [(a, NO_DROP if a == MOE else {}) for a in ATTENTION] + [
    ("mamba2-780m", {}), ("zamba2-2.7b", {}), (MOE, NO_DROP, MAX_LEN, True)]
RUN_IDS = [r[0] + ("-ep" if r[3:] else "") for r in RUNS]
TOL = 1e-5


def _helper_inputs(tmp):
    rng = np.random.default_rng(3)
    V = 12
    z = {"table": rng.normal(0, 1, (V, 5)), "tokens": rng.integers(0, V, (3, 4)),
         "logits": rng.normal(0, 3, (3, 4, V)),
         "labels": rng.integers(0, V, (3, 4)), "a": rng.normal(0, 1, (3, 4)),
         "b": rng.normal(0, 1, (3, 4)), "x": rng.normal(0, 1, (3, 8)),
         "r": rng.normal(0, 1, (3, 8))}
    ties = rng.normal(0, 1, (3, 1, V))
    ties[0, 0, [2, 8]] = 9.0     # the max on both ranks: index 2
    ties[1, 0, [7, 9]] = 9.0     # twice on rank 1: index 7
    ties[2, 0, 11] = 9.0         # once, last column
    z["ties"] = ties
    z = {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
         for k, v in z.items()}
    np.savez(tmp / "helpers.npz", **z)
    return z


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serve")
    inp = {"archs": np.array(ATTENTION), "max_len": MAX_LEN, "steps": STEPS}
    for arch, over in RUNS[:len(ATTENTION)]:
        _, params, batch = scaleout_ranks.serve_inputs(arch, over, B, S)
        save(str(tmp / f"ckpt_{arch}"), 0, params)
        inp[arch + "/ckpt"] = str(tmp / f"ckpt_{arch}")
        inp.update({f"{arch}/{k}": v.numpy() for k, v in batch.items()})
        inp.update({f"{arch}/{k}": v for k, v in over.items()})
    np.savez(tmp / "in_serve.npz", **inp)
    proc = scaleout_ranks.jax_process("serve_steps", tmp / "in_serve.npz",
                                      tmp / "jax_serve.npz")
    helpers = _helper_inputs(tmp)
    try:
        ranks = scaleout_ranks.spawn(
            "tp_serve_checks_rank", tmp, RUNS, B, S, MAX_LEN, STEPS,
            str(tmp / "helpers.npz"))
    finally:
        ref = scaleout_ranks.jax_result(proc, tmp / "jax_serve.npz")
    return ranks, ref, helpers


def one_rank(arch, over):
    """The port's one-rank prefill and serve steps: the tokens of each
    step, the prefill's logits and the last cache."""
    cfg, params, batch = scaleout_ranks.serve_inputs(arch, over, B, S)
    logits, cache = build_prefill_step(cfg, MAX_LEN)(params, batch)
    tok = torch.argmax(logits, -1).to(torch.int32)
    toks, serve = [tok], build_serve_step(cfg)
    for _ in range(STEPS):
        tok, cache = serve(params, tok, cache)
        toks.append(tok)
    return toks, logits, cache


def _same_on_every_rank(ranks, i):
    got = [r["served"][i] for r in ranks]
    for g in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(g["tokens"],
                                                     got[0]["tokens"]))
    return got[0]


@pytest.mark.parametrize("i", range(len(RUNS)), ids=RUN_IDS)
def test_sharded_serving_equals_one_rank(runs, i):
    ranks, _, _ = runs
    arch, over = RUNS[i][:2]
    got = _same_on_every_rank(ranks, i)
    toks, logits, cache = one_rank(arch, over)
    for a, b in zip(got["tokens"], toks, strict=True):
        assert torch.equal(a, b), (arch, a, b)
    assert float((got["logits"] - logits).abs().max()) <= TOL
    assert set(got["cache"]) == set(cache)
    for k, v in cache.items():
        d = float((got["cache"][k].float() - v.float()).abs().max())
        assert d <= TOL, (arch, k, d)


@pytest.mark.parametrize("arch", ATTENTION)
def test_sharded_serving_equals_jax_serve_shardings(runs, arch):
    ranks, ref, _ = runs
    got = _same_on_every_rank(ranks, ATTENTION.index(arch))
    for i, a in enumerate(got["tokens"]):
        assert np.array_equal(a.numpy(), ref[f"{arch}/tok{i}"]), (arch, i)
    assert np.abs(got["logits"].numpy() - ref[f"{arch}/logits"]).max() \
        <= TOL
    for k, v in got["cache"].items():
        want = ref[f"{arch}/cache/{k}"]
        assert v.shape == want.shape, (arch, k)
        d = np.abs(v.float().numpy() - want.astype(np.float32)).max()
        assert d <= TOL, (arch, k, d)


@pytest.mark.parametrize("arch", ATTENTION)
def test_each_rank_holds_its_rows_and_heads_of_the_cache(runs, arch):
    """[L, B/D, S, Hkv/M, hd] blocks of every KV leaf on each rank, the
    cross-attention's too (whisper), on (2, 2)."""
    ranks, _, _ = runs
    for r in ranks:
        got = r["served"][ATTENTION.index(arch)]
        for k, shape in got["local"].items():
            whole = got["cache"][k].shape
            if k == "len":
                assert shape == () and whole == ()
                continue
            assert shape == (whole[0], whole[1] // 2, whole[2],
                             whole[3] // 2, whole[4]), (arch, k, shape)


def test_vocab_parallel_helpers_equal_their_one_rank_formulas(runs):
    ranks, _, z = runs
    logits = torch.from_numpy(z["logits"]).requires_grad_(True)
    labels = torch.from_numpy(z["labels"]).long()
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    (torch.sum(lse * torch.from_numpy(z["a"]))
     - torch.sum(gold * torch.from_numpy(z["b"]))).backward()
    V = z["table"].shape[0]
    for r in ranks:
        h = r["helpers"]
        cols = slice(h["model"] * V // 2, (h["model"] + 1) * V // 2)
        assert torch.allclose(h["embed"], torch.from_numpy(
            z["table"][z["tokens"]]), atol=1e-6)
        assert torch.allclose(h["lse"], lse.detach(), atol=1e-5)
        assert torch.allclose(h["gold"], gold.detach(), atol=1e-6)
        assert torch.allclose(h["dlogits"], logits.grad[..., cols],
                              atol=1e-6)
        assert h["argmax"].tolist() == [[2], [7], [11]]
        assert h["argmax"].dtype == torch.int32
        x, rr = (torch.from_numpy(z[k]) for k in ("x", "r"))
        assert torch.equal(h["gathered"], x)
        mi = h["model"]
        assert torch.equal(h["dx"], rr[..., mi * 4:(mi + 1) * 4])


def test_helpers_are_the_identity_outside_the_context():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(0, 1, (10, 3)))
    tokens = torch.from_numpy(rng.integers(0, 10, (2, 5)))
    logits = torch.from_numpy(rng.normal(0, 1, (2, 5, 10)))
    assert tp.current_tp() is None
    assert torch.equal(tp.vocab_embed(table, tokens, 10), table[tokens])
    lse, gold = tp.vocab_lse_gold(logits, tokens, 10)
    assert torch.equal(lse, torch.logsumexp(logits, -1))
    assert torch.equal(gold, torch.gather(logits, -1,
                                          tokens[..., None])[..., 0])
    assert torch.equal(tp.vocab_argmax(logits, 10),
                       torch.argmax(logits, -1).to(torch.int32))
    for f in (tp.copy_to, tp.reduce_from, tp.gather_last):
        assert f(logits) is logits
    assert not tp.split(3, 10)
