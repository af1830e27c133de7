"""The metric arithmetic on synthetic stamps: rates over the whole
window, tails over every request (one with no first token counted at its
wait until the close), token gaps with both stamps inside the window."""
import statistics

import pytest

from chipbench import archs
from chipbench.harness import cells, endtoend
from chipbench.harness.record import ServeRecord, TrainRecord
from chipbench.harness.stats import percentile, spread
from chipbench.harness.wall import Call
from chipbench.metrics import reader
from chipbench.tests import smoke


def _rec(**kw):
    base = dict(cfg=None, arch=None, window=(10.0, 20.0), calls=[],
                stamps={}, due={}, joined={}, cap=4, chunk=16, page=16)
    base.update(kw)
    return ServeRecord(**base)


def test_output_rate_counts_stamps_inside_window_only():
    rec = _rec(stamps={0: [9.0, 10.0, 15.0, 20.0, 20.5], 1: [19.0]})
    # 10.0, 15.0, 20.0 and 19.0 lie in [10, 20]
    assert endtoend.output_tok_s(rec) == pytest.approx(4 / 10.0)


def test_token_gaps_need_both_stamps_inside():
    rec = _rec(stamps={0: [9.0, 10.5, 11.0, 21.0], 1: [12.0, 14.0]})
    assert sorted(endtoend.token_gaps(rec)) == pytest.approx([0.5, 2.0])
    gaps = [0.1 * i for i in range(1, 101)]
    stamps = {0: [10.0]}
    for g in gaps:
        stamps[0].append(stamps[0][-1] + g / 100)
    rec = _rec(stamps=stamps)
    assert endtoend.itl_p95_ms(rec) == pytest.approx(
        1e3 * percentile([g / 100 for g in gaps], 95))


def test_ttft_counts_unfinished_at_their_wait():
    rec = _rec(due={0: 11.0, 1: 12.0, 2: 18.0, 3: 9.0, 4: 21.0},
               stamps={0: [11.5, 12.0], 1: [20.5], 3: [10.2]})
    # 0 waits 0.5; 1's first token comes after the close: 20 - 12;
    # 2 has none: 20 - 18; 3 and 4 are not due in the window
    assert sorted(endtoend.ttfts(rec)) == pytest.approx([0.5, 2.0, 8.0])
    assert endtoend.ttft_p50_s(rec) == pytest.approx(2.0)
    assert "p50=2.0" in endtoend.tails(rec)
    assert endtoend.attempted(rec) == 3


def test_train_rate_is_whole_steps_over_window():
    """Steps that ended inside the window, and the share of the one
    crossing its close that lay inside, over the whole window."""
    rec = TrainRecord(cfg=None, arch=None, window=(0.0, 10.0),
                      step_ends=[1.5, 3.0, 4.5, 6.0, 7.5, 9.0, 10.5],
                      tokens_per_step=100, batch=1, seq=100)
    assert endtoend.train_steps(rec) == pytest.approx(6 + 1 / 1.5)
    assert endtoend.train_tok_s(rec) == pytest.approx(100 * (6 + 1 / 1.5)
                                                      / 10.0)
    assert endtoend.attempted(rec) == 6
    # a stall in the step that crosses the close lowers the rate
    stalled = TrainRecord(cfg=None, arch=None, window=(0.0, 10.0),
                          step_ends=[1.5, 3.0, 4.5, 6.0, 7.5, 9.0, 19.0],
                          tokens_per_step=100, batch=1, seq=100)
    assert endtoend.train_tok_s(stalled) == pytest.approx(61.0)


def test_percentile_and_spread():
    assert percentile([], 90) is None
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == pytest.approx(2.5)
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert spread(v) == pytest.approx((q3 - q1) / 12.5)


def _call(kind, t0, t1, rows, **kw):
    d = dict(logits_rows=len(rows), lens=[], kv_live=100, kv_reserved=200,
             launches={})
    d.update(kw)
    return Call(kind, t0, t1, rows, **d)


def test_readers_on_synthetic_calls():
    config = smoke.small_config(cells.load(smoke.TRAIN).config)
    cfg = cells.model_config(config)
    calls = [_call("decode", 11.0, 11.1, [(5, 1)] * 4),
             _call("prefill", 11.1, 11.5, [(0, 16)] * 2),
             _call("decode", 11.5, 11.7, [(6, 1)] * 2, kv_live=150),
             _call("decode", 19.9, 20.1, [(7, 1)])]          # straddles
    rec = _rec(cfg=cfg, arch=archs.for_config(config), calls=calls,
               due={0: 11.0, 1: 15.0, 2: 19.0},
               joined={0: 11.2, 1: 16.0})
    assert reader("decode_rows_mean.batch")(rec) == pytest.approx(3.0)
    assert reader("kv_live_share.batch")(rec) == pytest.approx(
        (0.5 + 0.75) / 2)
    assert reader("decode_call_ms.batch")(rec) == pytest.approx(150.0)
    assert reader("prefill_call_ms.batch")(rec) == pytest.approx(400.0)
    mfu = reader("mfu.batch")(rec)
    assert 0 < mfu < 100
    # no profile: the device readers find nothing, and say so
    for name in ("kernel_roofline.batch", "device_idle.batch"):
        assert reader(name)(rec) is None


def test_serving_roofline_counts_the_chunk_call_s_attention(capsys):
    """The profiled slice's chunk call launched the paged-prefill kernel
    and the norms: the reading is their least time over their device
    time, each family's printed; a count the trace lacks reads
    nothing."""
    from chipbench.harness.profiling import Summary
    from chipbench.roofline import kernels
    config = cells.load(smoke.BATCH).config
    cfg = cells.model_config(config)
    launches = {"paged_prefill_fwd": 48, "rmsnorm_fwd": 1,
                "add_rmsnorm_fwd": 96, "qk_norm_rope_fwd": 48}
    rows = [(640, 32), (1500, 32), (0, 5)]
    call = _call("prefill", 12.0, 12.2, rows, launches=launches)
    prof = Summary(window_s=4.0, busy_s=1.0, device_ops=[], idle_gaps=[],
                   family_s={"paged_prefill": 0.0026, "norm_fwd": 0.0004,
                             "qk_norm_rope_fwd": 0.0002},
                   family_n={"paged_prefill": 48, "norm_fwd": 97,
                             "qk_norm_rope_fwd": 48})
    rec = _rec(cfg=cfg, arch=archs.for_config(config), calls=[call],
               cap=16, chunk=32, profile=prof, profiled=(11.0, 13.0))
    least = kernels.serving_call_ms(
        cfg, kernels.CallShape("prefill", 16, 32, rows, [], 16), launches)
    assert reader("kernel_roofline.batch")(rec) == pytest.approx(
        100.0 * least / 3.2)
    assert "kernel family paged_prefill: least" in capsys.readouterr().err
    prof.family_n["paged_prefill"] = 47
    assert reader("kernel_roofline.batch")(rec) is None
