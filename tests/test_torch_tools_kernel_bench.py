"""``repro_torch.tools.kernel_bench`` on the CPU, and what every tensor
tool does without a card.

* The bound functions (shapes only, no device) give ``PERF.md`` §6's
  bound column at every launch the table names, to the digits it prints,
  and bound by what it says: the paged, flash and dense decode kernels
  at every served launch, the paged-prefill kernel at both chunk calls
  it is timed at, the SSD scan at both SSM paths' launches and
  one model rank's, ``rmsnorm_fwd`` and the fused forwards at their
  JSON-line and train launches, the split gated norm's four entries and
  the four backwards at the train step's launches.
* Every launch the timers name is a case of their tables.
* ``--device cpu`` times the plain versions alone at the JAX tool's CPU
  sizes and emits plain rows only.
* The five tools that compute with tensors raise without a card when
  no ``--device`` is given, and no tool holds a TPU constant.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.ssd_scan.cases import SSD_CASES, SSD_MAIN, SSD_TP
from repro_torch.tools import (common, kernel_bench as kb, quickstart,
                               serving_demo, shakeout_decode,
                               shakeout_models)

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
LENS = [161, 160, 151, 140, 129, 97, 64, 17]
#: the two chunk calls the paged-prefill kernel is timed at: 8 of 16 rows
#: prefilling (kernels/paged_prefill/cases.py::TIMED)
CHAT_CALL_STARTS = [640, 672, 704, 608, 736, 576, 768, 544] + [0] * 8
QWEN3_CHUNK_STARTS = [1408, 1536, 1280, 1664, 1152, 1536, 1408, 1280] + [0] * 8
SSD = {name: (shape, init) for name, shape, init in SSD_CASES}


def _ssd(name):
    (B, S, H, P, G, N, chunk), init = SSD[name]
    return kb.ssd_bound_ms(B, S, H, P, G, N, chunk, BF16, init)


#: (row of PERF.md §6, the bound function's (ms, bound by, ...), the
#: printed ms)
BOUNDS = [
    ("paged qwen3", kb.paged_bound_ms(8, 16, 128, 16, 8, LENS, BF16),
     "0.001233"),
    ("paged qwen3-moe", kb.paged_bound_ms(8, 32, 128, 16, 4, LENS, BF16),
     "0.000646"),
    ("paged_prefill chat call", kb.paged_prefill_bound(
        16, 32, 32, 4, 128, 16, CHAT_CALL_STARTS, [32] * 8 + [0] * 8, BF16),
     "0.004617"),
    ("paged_prefill qwen3 chunk", kb.paged_prefill_bound(
        16, 128, 16, 8, 128, 16, QWEN3_CHUNK_STARTS, [128] * 8 + [0] * 8,
        BF16), "0.01753"),
    ("flash qwen3", kb.flash_bound(8, 128, 16, 8, 128, 0, BF16), "0.003756"),
    ("flash zamba2", kb.flash_bound(8, 128, 32, 32, 80, 0, BF16),
     "0.006260"),
    ("flash qwen3-moe", kb.flash_bound(8, 128, 32, 4, 128, 0, BF16),
     "0.005634"),
    ("flash gemma2", kb.flash_bound(8, 128, 32, 16, 128, 4096, BF16),
     "0.007512"),
    ("flash gemma2 long", kb.flash_bound(2, 4160, 32, 16, 128, 4096, BF16),
     "0.2867"),
    ("flash whisper", kb.flash_bound(8, 128, 20, 20, 64, 0, BF16),
     "0.003130"),
    ("flash pixtral", kb.flash_bound(8, 132, 32, 8, 128, 0, BF16),
     "0.006456"),
    ("flash TP rank", kb.flash_bound(8, 128, 8, 4, 128, 0, BF16),
     "0.001878"),
    ("decode qwen3", kb.decode_bound(8, 161, 16, 8, 128, [145] * 8, 0, BF16),
     "0.001438"),
    ("decode zamba2", kb.decode_bound(8, 161, 32, 32, 80, [145] * 8, 0,
                                      BF16), "0.003570"),
    ("decode qwen3-moe", kb.decode_bound(8, 161, 32, 4, 128, [145] * 8, 0,
                                         BF16), "0.000748"),
    ("decode gemma2", kb.decode_bound(8, 161, 32, 16, 128, [145] * 8, 4096,
                                      BF16), "0.002876"),
    ("decode gemma2 long", kb.decode_bound(2, 4177, 32, 16, 128, [4170] * 2,
                                           4096, BF16), "0.02004"),
    ("decode whisper", kb.decode_bound(8, 161, 20, 20, 64, [145] * 8, 0,
                                       BF16), "0.001785"),
    ("decode pixtral", kb.decode_bound(8, 161, 32, 8, 128, [163] * 8, 0,
                                       BF16), "0.001614"),
    ("decode TP rank", kb.decode_bound(8, 144, 8, 4, 128, [144] * 8, 0,
                                       BF16), "0.000714"),
    ("ssd mamba2", _ssd(SSD_MAIN["mamba2-780m"]), "0.01567"),
    ("ssd zamba2", _ssd(SSD_MAIN["zamba2-2.7b"]), "0.009566"),
    ("ssd mamba2-tp2", _ssd(SSD_TP["mamba2-780m"]), "0.006006"),
    ("ssd zamba2-tp2", _ssd(SSD_TP["zamba2-2.7b"]), "0.004822"),
    ("rmsnorm_fwd qwen3-moe decode", kb.rmsnorm_bound((8, 1, 2048)),
     "0.0000208"),
    ("add_rmsnorm_fwd qwen3-moe decode",
     kb.fused_bound("add_rmsnorm_fwd", "qwen3-moe-30b-a3b", 8, 1),
     "0.0000403"),
    ("add_rmsnorm_fwd prefill",
     kb.fused_bound("add_rmsnorm_fwd", "qwen3-0.6b", 8, 128), "0.002505"),
    ("qk_norm_rope_fwd qwen3-moe paged decode",
     kb.fused_bound("qk_norm_rope_fwd", "qwen3-moe-30b-a3b", 8, 1, "rows"),
     "0.0000443"),
    ("qk_norm_rope_fwd prefill",
     kb.fused_bound("qk_norm_rope_fwd", "qwen3-0.6b", 8, 128, "seq"),
     "0.003757"),
    ("qk_norm_rope_fwd train",
     kb.fused_bound("qk_norm_rope_fwd", "qwen3-0.6b", 8, 1024, "seq"),
     "0.03005"),
    ("gated_rmsnorm_fwd zamba2 prefill",
     kb.fused_bound("gated_rmsnorm_fwd", "zamba2-2.7b", 8, 128), "0.009393"),
    ("gated_rmsnorm_fwd mamba2 prefill",
     kb.fused_bound("gated_rmsnorm_fwd", "mamba2-780m", 8, 384), "0.01690"),
    ("gated_rmsnorm_fwd mamba2 train",
     kb.fused_bound("gated_rmsnorm_fwd", "mamba2-780m", 4, 512), "0.01127"),
    ("gated_rmsnorm_sumsq",
     kb.split_bound("gated_rmsnorm_sumsq", 2048, 1536, 2, 2), "0.003759"),
    ("gated_rmsnorm_scale",
     kb.split_bound("gated_rmsnorm_scale", 2048, 1536, 2, 2), "0.005638"),
    ("gated_rmsnorm_dot",
     kb.split_bound("gated_rmsnorm_dot", 1024, 1536, 4, 4), "0.005637"),
    ("gated_rmsnorm_scale_bwd",
     kb.split_bound("gated_rmsnorm_scale_bwd", 1024, 1536, 4, 4),
     "0.009396"),
    ("rmsnorm_bwd [8192, 1024]",
     kb.norm_bwd_bound("rmsnorm_bwd", "qwen3-0.6b", 8, 1024), "0.01503"),
    ("add_rmsnorm_bwd",
     kb.norm_bwd_bound("add_rmsnorm_bwd", "qwen3-0.6b", 8, 1024),
     "0.02003"),
    ("qk_norm_rope_bwd",
     kb.norm_bwd_bound("qk_norm_rope_bwd", "qwen3-0.6b", 8, 1024),
     "0.04508"),
    ("gated_rmsnorm_bwd mamba2",
     kb.norm_bwd_bound("gated_rmsnorm_bwd", "mamba2-780m", 4, 512),
     "0.01878"),
]


@pytest.mark.parametrize("row,got,printed", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_bound_is_perf_md_column(row, got, printed):
    digits = len(printed.split(".")[1].lstrip("0"))
    assert f"{got[0]:.{digits}g}" == f"{float(printed):.{digits}g}", got
    assert got[1] == ("operations" if row == "flash gemma2 long"
                      else "bytes")


def test_timed_launches_are_cases():
    from repro_torch.kernels.paged_prefill.cases import TIMED
    assert [shape[6] for _, shape, _ in TIMED] == [CHAT_CALL_STARTS,
                                                   QWEN3_CHUNK_STARTS]
    paged = {c[0] for c in kb.CASES}
    assert all(name in paged for _, name, _ in kb.PAGED_TIMED)
    for cases in (kb.FLASH_CASES, kb.DECODE_CASES):
        names = {c[0] for c in cases}
        assert all(name in names for _, name in kb.TIMED)
    C = kb.norm_cases()
    assert Path(C.__file__).parent.name == "rmsnorm"
    assert set(C.BWD_TIMED) == set(C.BWD_ENTRIES)
    assert set(C.SPLIT_TIMED) == set(C.SPLIT_ENTRIES)


def test_cpu_mode_emits_plain_rows_only(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    payload = kb.main(["--device", "cpu"])
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("kernel_")]
    assert len(rows) == 6
    assert all(";plain" in ln.split(",", 2)[2] and "_plain" in ln
               for ln in rows), rows
    assert sorted(payload) == sorted(
        [f"attn_plain_S{S}" for S in (128, 256, 512)]
        + [f"ssd_plain_S{S}" for S in (256, 1024)] + ["rmsnorm_plain"])
    assert all(v["us"] > 0 for v in payload.values())
    assert (tmp_path / "bench_torch_kernels.json").exists()


TENSOR_TOOLS = [kb, shakeout_decode, shakeout_models, quickstart,
                serving_demo]


@pytest.mark.parametrize("tool", TENSOR_TOOLS,
                         ids=[t.__name__.rsplit(".", 1)[1]
                              for t in TENSOR_TOOLS])
def test_tool_raises_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tool.main([])


TOOLS = sorted((Path(kb.__file__).parent).glob("*.py"))


@pytest.mark.parametrize("path", TOOLS, ids=lambda p: p.name)
def test_no_tpu_constants_in_tools(path):
    text = path.read_text()
    assert "197e12" not in text and "819e9" not in text
    assert not re.search(r"\b4,?096(\.0)? ?GB|\b16 ?GB", text), path
    assert "host_mem_gb=4096" not in text
