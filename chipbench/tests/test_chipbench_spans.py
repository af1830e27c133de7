"""The slice by the program's ranges on synthetic kineto events: each
device operation put down through its launch's correlation id to the
ranges holding the launch, on any thread (autograd's launches inside the
main thread's ``train.backward``); idle gaps labelled by the innermost
range; the program's ranges leave ``profiling.summarise`` as it was; the
readers of the program's work counters."""
import sys

import pytest
import torch

from chipbench.harness import profiling, spans, work
from chipbench.metrics import reader
from chipbench.tests import test_chipbench_profiling as base

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
MS = 1_000_000


class _Event:
    def __init__(self, name, start_ms, dur_ms, device=CPU, corr=0, tid=1,
                 annotation=False):
        self._n, self._dev, self._c, self._t = name, device, corr, tid
        self._s, self._d = int(start_ms * MS), int(dur_ms * MS)
        self._a = annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def _kernel(name, launch_ms, start_ms, dur_ms, corr, tid=1):
    """A launch on thread ``tid`` and the device operation it started."""
    return [_Event("cudaLaunchKernel", launch_ms, 0.01, corr=corr, tid=tid),
            _Event(name, start_ms, dur_ms, CUDA, corr=corr, tid=tid)]


def _train_step():
    """A train step: the forward on the main thread, the backward's
    launches from autograd's thread (thread 2) while the main thread
    waits in ``train.backward``, the recompute's attention inside it."""
    return [
        _Event(profiling.SLICE, 0, 100, annotation=True),
        _Event("chipbench/train_step", 1, 98, annotation=True),
        _Event("chipbench/train_step", 2, 96, CUDA, annotation=True),
        _Event("train.forward", 2, 8),
        *_kernel("fwd_gemm", 3, 4, 4, corr=101),
        # a program range whose own correlation id equals a launch's
        _Event("train.backward", 10, 80, corr=102),
        _Event("model.attn", 20, 10, tid=2),
        *_kernel("recompute_gemm", 25, 26, 2, corr=102, tid=2),
        *_kernel("bwd_gemm", 40, 41, 4, corr=103, tid=2),
        _Event("train.optimizer", 92, 6),
        *_kernel("adam", 93, 94, 3, corr=104),
        # a device operation whose launch the trace lost
        _Event("lost", 98, 1, CUDA, corr=999),
    ]


def test_device_time_goes_to_the_ranges_holding_its_launch():
    sp = spans.read(_train_step())
    assert sp.device_s == pytest.approx(0.014)
    assert sp.unmatched_s == pytest.approx(0.001)
    assert sp.device("train.forward") == pytest.approx(0.004)
    # the second thread's launches lie in the main thread's backward
    assert sp.device("train.backward") == pytest.approx(0.006)
    assert sp.device("train.backward", "model.attn") == pytest.approx(0.002)
    assert sp.device("train.optimizer") == pytest.approx(0.003)
    assert dict(sp.innermost()) == pytest.approx(
        {"train.forward": 0.004, "model.attn": 0.002,
         "train.backward": 0.004, "train.optimizer": 0.003})
    assert sp.attributed == pytest.approx(13 / 14)
    assert sp.count == {"train.forward": 1, "train.backward": 1,
                        "model.attn": 1, "train.optimizer": 1}
    # under 95 % of the device time attributed: no quantity
    assert spans.METRICS["backward_ms"](sp) is None


def test_train_quantities_per_step():
    events = [e for e in _train_step() if e.name() != "lost"]
    sp = spans.read(events)
    assert sp.attributed == pytest.approx(1.0)
    assert spans.METRICS["backward_ms"](sp) == pytest.approx(6.0)
    assert spans.METRICS["optimizer_ms"](sp) == pytest.approx(3.0)
    # a serving quantity finds no range of its own here
    assert spans.METRICS["decode_idle_ms"](sp) is None


def _decode_calls():
    """Two decode calls, host-bound: kernels with idle gaps between
    them while the host launches inside the attention and MoE blocks."""
    ev = [_Event(profiling.SLICE, 0, 200, annotation=True)]
    corr = 200
    for c0 in (0, 100):
        ev += [_Event("chipbench/decode_call", c0 + 1, 98, annotation=True),
               _Event("chipbench/decode_call", c0 + 2, 96, CUDA,
                      annotation=True),
               _Event("serve.decode_call", c0 + 2, 96),
               _Event("serve.prepare", c0 + 2, 3),
               _Event("model.attn", c0 + 10, 30),
               _Event("model.moe", c0 + 40, 50),
               _Event("moe.experts", c0 + 60, 20)]
        for launch, start, dur in ((4, 5, 1), (20, 22, 2), (65, 70, 5),
                                   (92, 95, 2)):
            corr += 1
            ev += _kernel("k", c0 + launch, c0 + start, dur, corr=corr)
    return ev


def test_idle_gaps_carry_the_innermost_program_range():
    sp = spans.read(_decode_calls())
    idle = dict(sp.innermost(idle=True))
    # the first call's [0, 5) in serve.prepare; per call [6, 22) (mid 14)
    # in model.attn, [24, 70) (mid 47) and [75, 95) (mid 85) in
    # model.moe; [97, 105) (mid 101) and [197, 200) in the harness's
    # range, the program's call not yet entered or returned
    assert idle == pytest.approx({
        "serve.prepare": 0.005, "chipbench/decode_call": 0.008 + 0.003,
        "model.attn": 0.016 * 2, "model.moe": (0.046 + 0.020) * 2})
    assert sp.idle("serve.decode_call") == pytest.approx(0.169)
    assert spans.METRICS["decode_idle_ms"](sp) == pytest.approx(84.5)
    # the harness's range copied onto the device's timeline is no work
    assert sp.device_s == pytest.approx(0.020)
    assert sp.device("moe.experts") == pytest.approx(0.010)
    assert sp.count["serve.decode_call"] == 2


def test_prefill_attention_per_chunk_call():
    ev = [_Event(profiling.SLICE, 0, 50, annotation=True),
          _Event("serve.prefill_call", 1, 48),
          _Event("model.attn", 2, 10), _Event("model.moe", 12, 10),
          _Event("model.attn", 22, 10), _Event("model.unembed", 40, 5),
          *_kernel("a", 3, 3, 8, corr=1), *_kernel("m", 13, 13, 5, corr=2),
          *_kernel("a", 23, 23, 9, corr=3), *_kernel("u", 41, 41, 2, corr=4)]
    sp = spans.read(ev)
    assert spans.METRICS["prefill_attn_ms"](sp) == pytest.approx(17.0)
    assert sp.attributed == pytest.approx(1.0)


@pytest.mark.parametrize("tail_ms", [0, 3])
def test_program_ranges_leave_the_summary_as_it_was(tail_ms):
    """The port's ranges lie on the host's timeline only (they are not
    user annotations, which kineto copies onto the device's), with the
    launches of the same trace: ``summarise`` reads what it read."""
    plain = base._events(tail_ms * MS)
    ranged = plain + [
        _Event("serve.decode_call", 11, 78), _Event("model.attn", 15, 20),
        _Event("model.moe", 38, 40), _Event("moe.experts", 39, 5),
        _Event("cudaLaunchKernel", 16, 0.01, corr=7)]
    a, b = profiling.summarise(plain), profiling.summarise(ranged)
    assert (b.busy_s, b.window_s, b.family_n, b.family_s, b.idle_share,
            b.idle_gaps, b.device_ops) == (
        a.busy_s, a.window_s, a.family_n, a.family_s, a.idle_share,
        a.idle_gaps, a.device_ops)


def test_counter_readers_read_the_program_s_counters(monkeypatch):
    from repro_torch.obs.spans import COUNTERS
    monkeypatch.setattr(COUNTERS, "counters", {
        "serve.tokens_useful": 50.0, "serve.tokens_computed": 512.0,
        "attn.kv_live": 300.0, "attn.kv_gathered": 393216.0,
        "moe.pairs_routed": 4096.0, "moe.slots_computed": 65536.0})
    assert reader("prefill_token_use.batch")(None) == pytest.approx(50 / 512)
    assert reader("gather_live_share.batch")(None) == pytest.approx(
        300 / 393216)
    assert reader("moe_slot_use.batch")(None) == pytest.approx(1 / 16)
    monkeypatch.setattr(COUNTERS, "counters", {})
    assert reader("moe_slot_use.batch")(None) is None


def test_counter_readers_without_the_program_s_counters(monkeypatch):
    # a program that keeps no counters (the module cannot be imported)
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    assert work.ratio("moe.pairs_routed", "moe.slots_computed") is None
