"""The port's training driver (``repro_torch.launch.train``) on the CPU
at smoke size: it lowers the loss over 30 steps of the synthetic stream;
SIGTERM checkpoints the next step and stops, and ``--resume`` continues
from there to the same parameters as an uninterrupted run; ``--mesh``
and ``--ep-moe`` run on 4 gloo ranks; a missing card raises (no quiet
fall-back)."""
import os
import signal

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import latest_step
from repro_torch.launch import train
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)
SMOKE = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
         "4", "--seq", "32"]


def test_cli_lowers_the_loss(tmp_path, capsys):
    out = train.main(SMOKE + ["--steps", "30", "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "100"])
    losses = out["losses"]
    assert len(losses) == 30 and out["start"] == 0
    assert sum(losses[-5:]) / 5 < sum(losses[:5]) / 5 - 0.5
    printed = capsys.readouterr().out
    assert "step     0 loss=" in printed and "step    29 loss=" in printed
    assert latest_step(str(tmp_path)) is None     # ckpt-every past the end


def _signal_at(monkeypatch, at: int):
    """SIGTERM to this process while the driver fetches step ``at``'s
    batch."""
    real = train.make_batch

    def batch_then_signal(cfg, shape, dc, step, *a):
        if step == at:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(cfg, shape, dc, step, *a)
    monkeypatch.setattr(train, "make_batch", batch_then_signal)


def test_sigterm_checkpoints_and_resume_continues(tmp_path, monkeypatch,
                                                  capsys):
    """A run of 6 steps stopped by SIGTERM during step 2 checkpoints step
    3 and stops (restoring the previous handler); ``--resume`` continues
    from step 3 to the parameters and losses of an uninterrupted run."""
    args = SMOKE + ["--steps", "6", "--ckpt-every", "100"]
    whole = train.main(args + ["--ckpt-dir", str(tmp_path / "whole")])
    before = signal.getsignal(signal.SIGTERM)
    with monkeypatch.context() as m:
        _signal_at(m, 2)
        first = train.main(args + ["--ckpt-dir", str(tmp_path)])
    assert signal.getsignal(signal.SIGTERM) == before
    assert len(first["losses"]) == 3 and latest_step(str(tmp_path)) == 3
    assert "preemption signal: checkpointed at 3" in capsys.readouterr().out
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path), "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert resumed["start"] == 3 and len(resumed["losses"]) == 3
    assert first["losses"] + resumed["losses"] == whole["losses"]
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(whole["params"])):
        assert torch.equal(a, b)


MOE = ["--arch", "qwen3-moe-30b-a3b"] + SMOKE[2:]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The CLI on a (2, 2) mesh of 4 spawned gloo ranks (one spawn for
    every case) beside the runs without a mesh: qwen3 for 4 steps, qwen3
    resuming onto the mesh from a checkpoint of step 2 written without
    one (a run stopped by SIGTERM), the MoE for 3 steps with and without
    ``--ep-moe``."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    import scaleout_ranks
    tmp = tmp_path_factory.mktemp("mesh_cli")
    args = SMOKE + ["--steps", "4", "--ckpt-every", "100"]
    whole = train.main(args + ["--ckpt-dir", str(tmp / "whole")])
    with pytest.MonkeyPatch.context() as m:
        _signal_at(m, 1)
        train.main(args + ["--ckpt-dir", str(tmp / "stopped")])
    assert latest_step(str(tmp / "stopped")) == 2
    moe = MOE + ["--steps", "3", "--ckpt-every", "100", "--mesh", "2x2"]
    ranks = scaleout_ranks.spawn("cli_rank", tmp, [
        args + ["--mesh", "2x2", "--ckpt-dir", str(tmp / "mesh")],
        args + ["--mesh", "2x2", "--resume", "--ckpt-dir",
                str(tmp / "stopped")],
        moe + ["--ckpt-dir", str(tmp / "moe")],
        moe + ["--ep-moe", "--ckpt-dir", str(tmp / "moe_ep")]])
    for r in ranks:                     # every rank reports the same
        assert [x["losses"] for x in r] == [x["losses"]
                                            for x in ranks[0]]
    return whole["losses"], ranks[0]


@pytest.mark.parametrize("case", ["mesh 2x2", "resume onto the mesh",
                                  "ep-moe"])
def test_scale_out_flags_run(mesh_runs, case):
    """``--mesh 2x2`` gives the losses of the run without a mesh (within
    1e-4, the sharded step's bound); ``--resume`` onto the mesh from a
    checkpoint written without one continues them; ``--ep-moe`` runs
    ``moe_ffn_ep`` in every MoE layer of every step (twice under remat)
    and gives the losses of the mesh run without it (both route each data
    shard's tokens on their own)."""
    whole, runs = mesh_runs
    if case == "mesh 2x2":
        np.testing.assert_allclose(runs[0]["losses"], whole, atol=1e-4,
                                   rtol=0)
        assert runs[0]["ep_calls"] == 0
    elif case == "resume onto the mesh":
        assert runs[1]["start"] == 2
        np.testing.assert_allclose(runs[1]["losses"], whole[2:], atol=1e-4,
                                   rtol=0)
    else:
        plain, ep = runs[2], runs[3]
        assert plain["ep_calls"] == 0
        assert ep["ep_calls"] == 3 * 2 * ep["layers"]
        np.testing.assert_allclose(ep["losses"], plain["losses"],
                                   atol=1e-5, rtol=0)


def test_a_mesh_larger_than_the_process_group_raises(tmp_path):
    """Without torchrun's environment the driver sets up one gloo rank of
    its own, which cannot hold a 2x2 mesh: it raises and tears the group
    down."""
    with pytest.raises(ValueError, match="--mesh 2x2 needs 4 ranks"):
        train.main(SMOKE + ["--steps", "1", "--ckpt-dir", str(tmp_path),
                            "--mesh", "2x2"])
    assert not torch.distributed.is_initialized()


def test_ep_moe_needs_a_mesh(tmp_path):
    with pytest.raises(ValueError, match="--ep-moe runs on a mesh"):
        train.main(MOE + ["--steps", "1", "--ckpt-dir", str(tmp_path),
                          "--ep-moe"])


@pytest.mark.parametrize("mesh", [[], ["--mesh", "1x1"]], ids=["none", "1x1"])
def test_the_default_device_is_the_card(tmp_path, mesh):
    """Without ``--device`` the driver trains on the card, and without a
    card it raises rather than fall back to the CPU (or to gloo)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would train on it")
    args = [a for a in SMOKE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cuda needs a CUDA"):
        train.main(args + ["--steps", "1", "--ckpt-dir", str(tmp_path)]
                   + mesh)
    assert not torch.distributed.is_initialized()


#: the norm ops of the model, by name in ``kernels/rmsnorm/ops.py`` (on
#: the card each launches the kernel of the same name + ``_fwd``, and its
#: backward the one + ``_bwd``)
NORM_OPS = ("rmsnorm", "add_rmsnorm", "qk_norm_rope", "gated_rmsnorm")


def _train_norms_per_step(cfg, remat: str) -> dict:
    """Calls of each norm op in one train step: one forward (the first
    pre-norm and the final norm ``rmsnorm``, every other pre-norm
    ``add_rmsnorm``, each attention layer's ``qk_norm_rope``, each Mamba2
    layer's ``gated_rmsnorm``) and, under ``remat="full"``, the
    backward's recompute of every layer (all of them but the final
    norm).  chip_smoke.py's ``train_norm_launches`` holds phase 17's
    kernel launches to these counts."""
    L = cfg.num_layers
    apps = {"ssm": 0, "hybrid": L // max(cfg.attn_every, 1)}.get(
        cfg.family, L)
    mamba = L if cfg.family in ("ssm", "hybrid") else 0
    fwd = {"rmsnorm": 2, "add_rmsnorm": 2 * apps + mamba - 1,
           "qk_norm_rope": apps, "gated_rmsnorm": mamba}
    if remat == "none":
        return fwd
    return {op: 2 * n - (op == "rmsnorm" and n > 0) for op, n in fwd.items()}


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m",
                                  "zamba2-2.7b"])
def test_every_norm_of_a_train_step_goes_through_the_op(arch, remat,
                                                        monkeypatch):
    """The norm ops' calls in one train step on the CPU (each op is its
    kernels' wrapper on the card), with the layers recomputed or not."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels.rmsnorm import ops as t_ops
    from repro_torch.models import model as tm
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step
    cfg = get_config(arch, smoke=True).replace(
        param_dtype="float32", compute_dtype="float32", remat=remat)
    calls = {op: 0 for op in NORM_OPS}

    def counted(op):
        real = getattr(t_ops, op)

        def call(*a, **k):
            calls[op] += 1
            return real(*a, **k)
        return call
    for op in NORM_OPS:
        monkeypatch.setattr(t_ops, op, counted(op))
    p = tm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(3, cfg.vocab_size, (2, 8))
    batch = {"tokens": toks, "labels": toks}
    tc = TrainConfig()
    build_train_step(cfg, tc)(p, optim.init_opt_state(p, tc), batch)
    assert calls == _train_norms_per_step(cfg, remat)
