"""The port's paged model steps against the JAX package's on qwen3-0.6b
smoke (f32, CPU) with bridged weights: two prefill chunks over shuffled
page tables with one inactive row, then four decode steps.  Logits are
compared on active rows only (inactive rows are garbage by contract) at
atol 1e-4: three layers of f32 matmuls and softmaxes summed in a
different order stay well inside it.  Page pools are compared at every
live position at the same tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as tm
from repro_torch.models.params import from_jax
from repro_torch.train.step import (build_paged_decode_step,
                                    build_prefill_chunk_step)

torch.set_num_threads(1)
ATOL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _setup(seed=0):
    jcfg = j_get_config("qwen3-0.6b", smoke=True).replace(**F32)
    tcfg = t_get_config("qwen3-0.6b", smoke=True).replace(**F32)
    jp = jm.init(jcfg, jax.random.key(seed))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _live_pages(table, lens, page):
    for b, n in enumerate(lens):
        for pos in range(n):
            yield b, pos, table[b, pos // page], pos % page


def test_prefill_chunks_then_decode_match_jax():
    jcfg, tcfg, jp, tp = _setup()
    r = np.random.default_rng(5)
    B, page, num_pages, C = 3, 4, 16, 6
    prompt_lens = [10, 7, 0]                     # row 2 stays inactive
    prompts = [r.integers(3, jcfg.vocab_size, n) for n in prompt_lens]
    maxp = num_pages - 1
    perm = list(r.permutation(np.arange(1, num_pages)))
    table = np.zeros((B, maxp), np.int32)
    for b in range(2):                           # room for 14 tokens
        table[b, :4] = [perm.pop() for _ in range(4)]

    jc = jm.init_paged_cache(jcfg, B, num_pages, page)
    tc = tm.init_paged_cache(tcfg, B, num_pages, page, device="cpu")
    jc["table"], tc["table"] = jnp.asarray(table), torch.from_numpy(table)
    chunk_j = jax.jit(lambda p, c, *a: jm.prefill_chunk(p, jcfg, c, *a))
    chunk_t = build_prefill_chunk_step(tcfg)
    active = np.asarray([True, True, False])
    lens = np.zeros(B, np.int32)
    for s0 in (0, C):                            # two chunks
        toks = np.full((B, C), 3, np.int32)
        cl = np.zeros(B, np.int32)
        for b in range(2):
            seg = prompts[b][s0:s0 + C]
            toks[b, :len(seg)], cl[b] = seg, len(seg)
        start = np.asarray([s0, s0, 0], np.int32)
        jc["lens"], tc["lens"] = jnp.asarray(lens), torch.from_numpy(lens)
        lj, jc = chunk_j(jp, jc, jnp.asarray(toks), jnp.asarray(start),
                         jnp.asarray(cl), jnp.asarray(active))
        lt, tc = chunk_t(tp, tc, torch.from_numpy(toks).long(),
                         torch.from_numpy(start), torch.from_numpy(cl),
                         torch.from_numpy(active))
        np.testing.assert_allclose(lt.numpy()[:2], np.asarray(lj)[:2],
                                   atol=ATOL, rtol=ATOL)
        lens = np.array(jc["lens"])
        np.testing.assert_array_equal(tc["lens"].numpy(), lens)
    assert list(lens[:2]) == prompt_lens[:2]

    dec_j = jax.jit(lambda p, c, t, a: jm.decode_step_paged(p, jcfg, c, t,
                                                            a))
    dec_t = build_paged_decode_step(tcfg)
    token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)   # [B, 1]
    for _ in range(4):
        lj, jc = dec_j(jp, jc, jnp.asarray(token), jnp.asarray(active))
        lt, tc = dec_t(tp, tc, torch.from_numpy(token).long(),
                       torch.from_numpy(active))
        np.testing.assert_allclose(lt.numpy()[:2], np.asarray(lj)[:2],
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_array_equal(tc["lens"].numpy(),
                                      np.asarray(jc["lens"]))
        token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    final = np.asarray(jc["lens"])
    assert list(final) == [14, 11, 0]
    for key in ("k", "v"):
        jpool, tpool = np.asarray(jc[key]), tc[key].numpy()
        for b, pos, pid, off in _live_pages(table, final, page):
            np.testing.assert_allclose(tpool[:, pid, off], jpool[:, pid, off],
                                       atol=ATOL, rtol=ATOL,
                                       err_msg=f"{key} row {b} pos {pos}")


def test_paged_path_rejects_other_families():
    cfg = t_get_config("qwen3-moe-30b-a3b", smoke=True)
    with pytest.raises(NotImplementedError, match="slice 2"):
        tm.init_paged_cache(cfg, 1, 4, 4, device="cpu")
    for arch in ("gemma2-27b", "mamba2-780m"):
        with pytest.raises(NotImplementedError):
            tm.init_paged_cache(t_get_config(arch, smoke=True), 1, 4, 4,
                                abstract_only=True)
