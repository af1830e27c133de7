"""The frozen formulas equal the kernel bench's bounds at the shapes of
PERF.md's kernel table, the families' sums follow the launches, and the
model's FLOPs count what they say."""
import pytest
import torch

from chipbench.harness import cells
from chipbench.roofline import kernels, peaks

from repro_torch.tools import kernel_bench as kb


def _w(arch):
    from repro_torch.configs import get_config
    return kernels.widths(get_config(arch))


def test_peaks_are_the_bench_s():
    assert kb.HBM_BYTES_S == peaks.HBM_BYTES_S
    assert kb.PEAK_OPS_S[torch.bfloat16] == peaks.BF16_FLOPS
    assert kb.PEAK_OPS_S[torch.float32] == peaks.F32_FLOPS


@pytest.mark.parametrize("B,Hq,Hkv,lens", [
    (8, 16, 8, [128] * 8), (8, 32, 4, [128] * 8), (8, 32, 4, [129] * 8),
    (16, 32, 4, [1, 17, 300, 2816] * 4)])
def test_paged_bound(B, Hq, Hkv, lens):
    assert kernels.paged_bound_ms(B, Hq, 128, 16, Hkv, lens) == \
        kb.paged_bound_ms(B, Hq, 128, 16, Hkv, lens, torch.bfloat16)


@pytest.mark.parametrize("shape", [(8, 2048), (8, 1024), (8, 128, 5120),
                                   (8192, 1024)])
def test_rmsnorm_bound(shape):
    rows = 1
    for s in shape[:-1]:
        rows *= s
    assert kernels.rmsnorm_bound(rows, shape[-1]) == kb.rmsnorm_bound(shape)


@pytest.mark.parametrize("arch,B,S,positions", [
    ("qwen3-moe-30b-a3b", 8, 1, "rows"), ("qwen3-0.6b", 8, 1, "rows"),
    ("qwen3-0.6b", 8, 128, "seq"), ("qwen3-0.6b", 8, 1024, "seq")])
def test_fused_bounds(arch, B, S, positions):
    w = _w(arch)
    assert kernels.add_rmsnorm_bound(B * S, w["d"]) == \
        kb.fused_bound("add_rmsnorm_fwd", arch, B, S)
    pos_bytes = kb._POSITION_BYTES[positions](B, S)
    assert kernels.qk_norm_rope_bound(B, S, w["Hq"], w["Hkv"], w["D"],
                                      pos_bytes, w["qk_norm"]) == \
        kb.fused_bound("qk_norm_rope_fwd", arch, B, S, positions)


@pytest.mark.parametrize("entry", ["rmsnorm_bwd", "add_rmsnorm_bwd",
                                   "qk_norm_rope_bwd"])
def test_norm_bwd_bound(entry):
    w = _w("qwen3-0.6b")
    assert kernels.norm_bwd_bound(entry, 8, 1024, w["d"], w["Hq"], w["Hkv"],
                                  w["D"], w["qk_norm"]) == \
        kb.norm_bwd_bound(entry, "qwen3-0.6b", 8, 1024)


@pytest.mark.parametrize("case", [0, 1])
def test_paged_prefill_bound(case):
    """The chunk call's attention at the kernel bench's timed launches
    (the chat call, 0.004617 ms; qwen3-0.6b's chunk of 128, 0.01753 ms)."""
    from repro_torch.kernels.paged_prefill.cases import TIMED
    _, (B, page, Hq, Hkv, D, C, starts, lens, _), _ = TIMED[case]
    got = kernels.paged_prefill_bound(B, Hq, Hkv, D, page, starts, lens)
    assert got == kb.paged_prefill_bound(B, C, Hq, Hkv, D, page, starts,
                                         lens, torch.bfloat16)
    assert got[0] == pytest.approx([0.004617, 0.01753][case], rel=1e-3)
    assert got[1] == "bytes"


def _shape(kind, rows=(), lens=(), cap=16, chunk=128):
    return kernels.CallShape(kind, cap, chunk, list(rows), list(lens), 16)


def test_call_sums_follow_the_launches():
    cfg = cells.model_config(cells.load("qwen3-0.6b.train-16k").config)
    w = kernels.widths(cfg)
    launches = {"rmsnorm_fwd": 1, "add_rmsnorm_fwd": 56,
                "qk_norm_rope_fwd": 28}
    rows = [(0, 128), (1408, 128), (4000, 7)]
    got = kernels.serving_call_ms(cfg, _shape("prefill", rows), launches)
    want = (kernels.rmsnorm_bound(16 * 128, 1024)[0]
            + 55 * kernels.add_rmsnorm_bound(16 * 128, 1024)[0]
            + kernels.add_rmsnorm_bound(16, 1024)[0]
            + 28 * kernels.qk_norm_rope_bound(16, 128, 16, 8, 128,
                                              4 * 16 * 128)[0])
    assert got == pytest.approx(want)
    # the chunk call's attention: each launch at the prefilling rows'
    # starts and chunk lengths
    got = kernels.serving_call_ms(cfg, _shape("prefill", rows),
                                  dict(launches, paged_prefill_fwd=28))
    assert got == pytest.approx(want + 28 * kernels.paged_prefill_bound(
        16, 16, 8, 128, 16, [0, 1408, 4000], [128, 128, 7])[0])
    lens = [5, 100, 1, 1]
    got = kernels.serving_call_ms(cfg, _shape("decode", lens=lens, cap=4),
                                  {"paged_attention_fwd": 28})
    assert got == pytest.approx(28 * kernels.paged_bound_ms(
        4, w["Hq"], w["D"], 16, w["Hkv"], lens)[0])


def test_families_cover_the_launchers():
    """Every launcher entry is counted by some family, and every family's
    pattern finds its kernels' device names."""
    assert kernels.KERNEL_FAMILIES["paged_prefill"][1] == (
        "paged_prefill_fwd",)
    assert kernels.ENTRIES["paged_prefill_fwd"] == \
        "repro_torch.kernels.paged_prefill.kernel"
    import re
    for name in ("void (anonymous namespace)::paged_prefill_wgmma_kernel"
                 "<128, 8>(Args)", "paged_prefill_f32_kernel<64>"):
        hits = [f for f, (pat, _) in kernels.KERNEL_FAMILIES.items()
                if re.search(pat, name)]
        assert hits == ["paged_prefill"]


def test_model_flops():
    from chipbench.archs import qwen3
    moe = cells.model_config(cells.load("qwen3-moe-30b-a3b.chat-batch")
                             .config)
    dense = cells.model_config(cells.load("qwen3-0.6b.train-16k").config)
    # qwen3-30b-a3b activates about 3.3 billion parameters a token
    active = qwen3.body_params_per_token(moe) + 2048 * 151936
    assert 3.0e9 < active < 3.5e9
    assert qwen3.attention_pairs([(0, 4)]) == 10
    assert qwen3.attention_pairs([(10, 1)]) == 11
    f = qwen3.forward_flops(dense, [(0, 1)], 1)
    assert f == pytest.approx(2 * (qwen3.body_params_per_token(dense)
                                   + 1024 * 151936)
                              + 4 * 16 * 128 * 28)
    # about 3.9 GFLOP a token for qwen3-0.6b training at 1,024
    per_tok = qwen3.train_step_flops(dense, 16, 1024) / 16384
    assert 3.5e9 < per_tok < 4.2e9
