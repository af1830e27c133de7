"""The trace's summary on synthetic profiler events: every device
operation counts, also one whose stamp lies past the host's range of the
slice, and the window reaches over it; a user annotation on the device's
timeline is no device work."""
import pytest
import torch

from chipbench.harness import profiling

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class _Event:
    def __init__(self, name, start_ns, dur_ns, device, user=False):
        self._n, self._s, self._d, self._dev = name, start_ns, dur_ns, device
        self._user = user

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._user


def _events(tail_ns):
    ms = 1_000_000
    return [
        _Event(profiling.SLICE, 0, 100 * ms, CPU),
        _Event("chipbench/decode_call", 10 * ms, 80 * ms, CPU),
        _Event("chipbench/decode_call", 10 * ms, 80 * ms, CUDA, user=True),
        _Event("void attn::paged_decode_split_kernel<8>", 20 * ms, 10 * ms,
               CUDA),
        _Event("void rms::norm_kernel<bf16>", 40 * ms, 5 * ms, CUDA),
        # the slice's last kernel, stamped after the host left the range
        _Event("void rms::norm_kernel<bf16>", 100 * ms + tail_ns - 2 * ms,
               2 * ms, CUDA),
    ]


@pytest.mark.parametrize("tail_ms", [0, 3])
def test_every_device_operation_counts(tail_ms):
    ms = 1_000_000
    s = profiling.summarise(_events(tail_ms * ms))
    assert s.family_n == {"paged_decode": 1, "norm_fwd": 2}
    assert s.family_s["norm_fwd"] == pytest.approx(0.007)
    assert s.window_s == pytest.approx(0.1 + tail_ms / 1e3)
    assert s.busy_s == pytest.approx(0.017)
    assert s.busy_s <= s.window_s
    # the harness's own ranges on the device's timeline are no device work
    assert all(not n.startswith("chipbench/") for n, _ in s.device_ops)
    assert dict(s.idle_gaps)["chipbench/decode_call"] > 0


def test_user_annotations_are_no_device_work():
    """A ``record_function`` range of any name (here one the program
    might open) copied onto the device's timeline changes nothing."""
    ms = 1_000_000
    base = profiling.summarise(_events(0))
    s = profiling.summarise(_events(0) + [
        _Event("model.attn", 50 * ms, 30 * ms, CUDA, user=True)])
    assert s.busy_s == pytest.approx(base.busy_s)
    assert s.idle_share == pytest.approx(base.idle_share)
    assert s.family_n == base.family_n
    assert "model.attn" not in dict(s.device_ops)
