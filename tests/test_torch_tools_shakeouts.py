"""The port's shakeouts (``repro_torch.tools.shakeout_models`` and
``shakeout_decode``) on the CPU: each arch's function passes (every arch
through train forward, prefill and two decode steps without a NaN;
prefill + decode logits within ``TOL`` of ``forward_train``'s in f32),
the MoE arch at the config's own capacity factor really differs (why
the decode check runs it at ``no_drop_factor``), and ``main`` prints an
``OK`` or ``FAIL`` line per arch and returns the archs that failed."""
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.tools import shakeout_decode, shakeout_models

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_models_arch_passes(arch):
    line = shakeout_models.check_arch(arch, CPU)
    assert line.startswith("train (2, ") and "len=" in line


@pytest.mark.parametrize("arch", shakeout_decode.ARCHS)
def test_decode_arch_within_tol(arch):
    assert shakeout_decode.check_arch(arch, CPU) < shakeout_decode.TOL


def test_moe_drops_differ_at_own_capacity(monkeypatch):
    monkeypatch.setattr(shakeout_decode, "no_drop_factor",
                        lambda cfg: cfg.capacity_factor)
    assert shakeout_decode.check_arch("qwen3-moe-30b-a3b", CPU) > \
        shakeout_decode.TOL


def test_main_lines_and_failures(monkeypatch, capsys):
    monkeypatch.setattr(shakeout_models, "ARCH_IDS",
                        ["qwen3-0.6b", "no-such-arch"])
    assert shakeout_models.main(["--device", "cpu"]) == ["no-such-arch"]
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("OK   qwen3-0.6b: train (2, 32, 64)")
    assert out[1].startswith("FAIL no-such-arch: KeyError")
    monkeypatch.setattr(shakeout_decode, "ARCHS", ["mamba2-780m"])
    assert shakeout_decode.main(["--device", "cpu"]) == []
    monkeypatch.setattr(shakeout_decode, "TOL", 0.0)
    assert shakeout_decode.main(["--device", "cpu"]) == ["mamba2-780m"]
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("OK   mamba2-780m: max |logit diff| = ")
    assert out[1].startswith("FAIL mamba2-780m: ")
