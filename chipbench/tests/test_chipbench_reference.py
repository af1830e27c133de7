"""The plain reference against the port at smoke sizes on the CPU, in
float32: the same logits (the MoE dropless), the same served tokens
through the engine and paged backend, and the same three train steps."""
import copy

import pytest
import torch

from chipbench.harness import cells, serve, weights
from chipbench.reference import qwen3
from chipbench.reference import train as ref_train
from chipbench.reference.compare import train_numbers
from chipbench.tests import smoke


def _f32(config):
    c = copy.deepcopy(config)
    c["torch_dtype"] = "float32"
    if "training" in c:
        c["training"] = dict(c["training"], param_dtype="float32")
    return c


@pytest.mark.parametrize("name", [smoke.BATCH, smoke.OPEN])
def test_logits_equal_the_port(name):
    from repro_torch.models import model
    config = _f32(smoke.cell(name).config)
    cfg = cells.model_config(config)
    params = weights.make(cfg, 11, "cpu")
    tokens = torch.randint(4, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        hidden, _ = model.forward_train(params, cfg, {"tokens": tokens})
        want = model.lm_logits(params, cfg, hidden)
    dm = qwen3.Dims.of(config)
    got = qwen3.logits_at(params, dm, tokens.tolist(), [range(24)] * 2,
                          "cpu")
    for g, w in zip(got, want):
        assert torch.allclose(g, w, atol=2e-5, rtol=1e-5), \
            (g - w).abs().max()


@pytest.mark.parametrize("name", [smoke.BATCH, smoke.OPEN])
def test_served_tokens_are_the_reference_best(name):
    """Through the engine, paged backend, chunked prefill and paged
    decode in float32, every served token is the reference's best."""
    cell = smoke.cell(name)
    cell.config = _f32(cell.config)
    rec, rd = serve.run(cell, 21, 2.0, False, device="cpu")
    served = rd["sample"]["served"]
    assert sum(len(s) for s in served) >= 20
    assert rd["numbers"]["logit_gap_max"]["value"] < 1e-4


def test_three_train_steps_equal_the_port():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step
    from chipbench.traffic.train_batches import Batches
    cell = smoke.cell(smoke.TRAIN)
    config = _f32(cell.config)
    cfg = cells.model_config(config, training=True)
    hp = cell.workload["optimizer"]
    tc = TrainConfig(learning_rate=hp["learning_rate"],
                     warmup_steps=hp["warmup_steps"],
                     total_steps=hp["total_steps"],
                     weight_decay=hp["weight_decay"], beta1=hp["beta1"],
                     beta2=hp["beta2"], eps=hp["eps"],
                     grad_clip=hp["grad_clip"])
    data = Batches(cell.workload["batches"], 4, cfg.vocab_size, "cpu")
    batches = [data.next() for _ in range(3)]
    params = weights.make(cfg, 4, "cpu")
    start = params
    opt = optim.init_opt_state(params, tc)
    step = build_train_step(cfg, tc)
    losses = []
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["total_loss"]))
        if i == 0:
            grad = {k: float(v.norm()) / (1 - tc.beta1)
                    for k, v in ref_train.leaves(opt.m).items()}
    change = {k: float((v - s).norm()) for (k, v), s in zip(
        ref_train.leaves(params).items(), ref_train.leaves(start).values())}
    ref = ref_train.run(weights.make(cfg, 4, "cpu"), qwen3,
                        qwen3.Dims.of(config),
                        batches, hp, store_dtype=torch.float32)
    nums = train_numbers({"losses": losses, "grad": grad,
                          "change": change}, ref)
    assert nums["loss_gap"]["value"] < 1e-5
    assert nums["grad_gap"]["value"] < 1e-4
    assert nums["change_gap"]["value"] < 1e-3
