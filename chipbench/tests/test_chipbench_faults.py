"""The check fails what it must: a run driven past the harness's look
for a card, with the timed path broken underneath, comes out not
correct, and so does the control (the reference in fp8).  At a smoke
size on the CPU, a limit is set as the calibration sets it, between the
sound run's reading and the broken one's; on the card the same
procedure runs at the cells' sizes (``calibrate.py``)."""
import pytest
import torch

from chipbench.harness import cells, faults, serve, train, weights
from chipbench.reference import qwen3
from chipbench.reference import train as ref_train
from chipbench.reference.compare import judge, serve_numbers, train_numbers
from chipbench.tests import smoke
from chipbench.traffic.train_batches import Batches


def _altered(r, tok):
    """Every token after a request's first replaced where it is
    produced."""
    return (tok + 97) % 256 if len(r.tokens) >= 2 else tok


def _one_request():
    """The same in one request alone, the first long one it reaches: a
    fault confined to one row of the batch."""
    hit = []

    def tamper(r, tok):
        if not hit and r.max_new_tokens >= 2 * smoke.MIN_TOKENS:
            hit.append(r.rid)
        return _altered(r, tok) if hit and r.rid == hit[0] else tok
    tamper.hit = hit
    return tamper


@pytest.mark.parametrize("fault", ["every", "one"])
@pytest.mark.parametrize("name", [smoke.BATCH, smoke.OPEN])
def test_serving_fault_and_control_fail(name, fault):
    """The numbers the cell compares (the widest gap; for the MoE, whose
    top-k routing flips on rounding, the gap a fifth of the tokens reach
    and the largest median gap of one request) fail tokens altered in every request, in one request alone,
    and the control.  The check samples every request served here, so
    the one altered request is in it."""
    cell = smoke.cell(name)
    cell.workload["check"].update(sample_tokens=10**6, most_requests=10**6)
    keys = list(cell.workload["check"]["limits"])
    _, sound = serve.run(cell, 31, 3.0, False, device="cpu")
    tamper = _altered if fault == "every" else _one_request()
    _, bad = serve.run(cell, 31, 3.0, False, device="cpu", tamper=tamper)
    if fault == "one":
        rid, = tamper.hit
        assert rid in bad["sample"]["rids"] and len(bad["sample"]["rids"]) >= 3
    params = weights.make(cells.model_config(cell.config), 31, "cpu")
    min_tokens = int(cell.workload["check"].get("request_min_tokens", 1))
    ctl = serve_numbers(qwen3.served_gaps(
        params, qwen3.Dims.of(cell.config), sound["sample"]["prompts"],
        sound["sample"]["served"], "cpu", quant=True), min_tokens)
    # each compared number's limit as the calibration sets it: half the
    # least broken reading that is three times the sound one or more
    low = {k: sound["numbers"][k]["value"] for k in keys}
    limits = {}
    for k in keys:
        ups = [r[k]["value"] for r in (bad["numbers"], ctl)
               if r[k]["value"] >= 3 * low[k] and r[k]["value"] > 0]
        if ups:
            limits[k] = min(ups) / 2
    assert judge(sound["numbers"], limits), (limits, low)
    for what, nums in (("fault", bad["numbers"]), ("control", ctl)):
        assert not judge(nums, limits), (what, limits, low, nums)


def test_training_faults_and_control_fail():
    cell = smoke.cell(smoke.TRAIN)
    _, sound = train.run(cell, 41, 0.5, False, device="cpu")
    low = {k: n["value"] for k, n in sound["numbers"].items()}
    broken = {}
    for fault in (faults.unchanged, faults.half_batch):
        _, r = train.run(cell, 41, 0.5, False, device="cpu", fault=fault)
        broken[fault.__name__] = {k: n["value"]
                                  for k, n in r["numbers"].items()}
    cfg = cells.model_config(cell.config, training=True)
    data = Batches(cell.workload["batches"], 41, cfg.vocab_size, "cpu")
    first = [data.next() for _ in range(train.CHECKED_STEPS)]
    dm, hp = qwen3.Dims.of(cell.config), cell.workload["optimizer"]
    ref = ref_train.run(weights.make(cfg, 41, "cpu"), qwen3, dm, first,
                        hp)
    ctl = ref_train.run(weights.make(cfg, 41, "cpu"), qwen3, dm, first,
                        hp, quant=True)
    broken["control"] = {k: n["value"]
                         for k, n in train_numbers(ctl, ref).items()}
    # a state left unchanged reads 1 on the change; half a batch fails
    # some number by ten times its sound reading, the control by three
    assert broken["unchanged"]["change_gap"] == pytest.approx(1.0)
    for what, times in (("half_batch", 10), ("control", 3)):
        nums = broken[what]
        assert any(nums[k] >= times * low[k] for k in low), (what, nums, low)
    limits = {k: 2 * v for k, v in low.items()}
    assert judge(sound["numbers"], limits)
    for what, nums in broken.items():
        assert not judge({k: {"value": v} for k, v in nums.items()},
                         limits), what
