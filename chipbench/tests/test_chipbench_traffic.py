"""Traffic is a function of the seed; every seed gets the same sizes and
arrival times, in another order within blocks."""
import numpy as np
import pytest
import torch

from chipbench.harness import cells
from chipbench.tests import smoke
from chipbench.traffic import requests, train_batches

SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]


@pytest.mark.parametrize("name", [smoke.BATCH, smoke.OPEN])
def test_requests_deterministic_and_same_work(name):
    params = smoke.cell(name).workload["requests"]
    if name == smoke.BATCH:
        params = cells.load(name).workload["requests"]
    runs = {s: requests.make(params, s, 60.0, 151936) for s in SEEDS}
    again = requests.make(params, SEEDS[2], 60.0, 151936)
    assert [(r.due, r.prompt, r.max_new) for r in again] == \
        [(r.due, r.prompt, r.max_new) for r in runs[SEEDS[2]]]
    base = runs[SEEDS[0]]
    block = params["shuffle_block"]
    for s, reqs in runs.items():
        assert [r.due for r in reqs] == [r.due for r in base]
        for lo in range(0, len(base), block):
            got = sorted((len(r.prompt), r.max_new) for r in reqs[lo:lo + block])
            want = sorted((len(r.prompt), r.max_new)
                          for r in base[lo:lo + block])
            assert got == want
    assert runs[SEEDS[0]][0].prompt != runs[SEEDS[1]][0].prompt
    lo, hi = params["prompt"]["min"], params["prompt"]["max"]
    assert all(lo <= len(r.prompt) <= hi for r in base)
    assert all(requests.FIRST_TOKEN <= t < 151936
               for r in base[:8] for t in r.prompt)


def test_backlog_first_block_fits_the_pool():
    """The chat backlog's first 16 requests reserve their worst case
    together within the pool, so every row fills at the first join."""
    cell = cells.load("qwen3-moe-30b-a3b.chat-batch")
    srv = cell.config["serving"]
    reqs = requests.make(cell.workload["requests"], 3, 60.0, 151936)
    page = srv["page_size"]
    pages = sum(-(-(len(r.prompt) + r.max_new) // page)
                for r in reqs[:srv["max_batch"]])
    assert pages <= srv["kv_pool_tokens"] // page


def test_poisson_rate_and_backlog_count():
    p = dict(smoke.OPEN_WORKLOAD["requests"], rate_per_s=3.0)
    due = requests.arrival_times(p, 400.0)
    assert abs(len(due) / 400.0 - 3.0) < 0.3
    assert np.all(np.diff(due) > 0) and due[-1] < 400.0
    b = cells.load("qwen3-moe-30b-a3b.chat-batch").workload["requests"]
    assert len(requests.arrival_times(b, 1.0)) == b["count"]


def test_block_permutation_stays_in_blocks():
    rng = np.random.default_rng(1)
    perm = requests.block_permutation(rng, 37, 8)
    assert sorted(perm) == list(range(37))
    assert all(i // 8 == p // 8 for i, p in enumerate(perm))


def test_train_batches_deterministic():
    p = {"batch": 3, "seq": 16}
    a = train_batches.Batches(p, 2**31 + 9, 1000, "cpu")
    b = train_batches.Batches(p, 2**31 + 9, 1000, "cpu")
    x, y = a.next(), b.next()
    assert torch.equal(x["tokens"], y["tokens"])
    assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert not torch.equal(a.next()["tokens"], x["tokens"])
    rows = x["tokens"]
    assert len({tuple(r.tolist()) for r in rows}) == 3
