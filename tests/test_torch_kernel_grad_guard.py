"""The port's kernels have no backward, so each of the eight launchers
refuses an input that requires grad while grad is enabled, before it looks
at the device (so these run on the CPU).  Without grad the same call goes
on to the launcher's own checks, which refuse a CPU tensor."""
import pytest
import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.paged_attention.kernel import paged_attention_fwd
from repro_torch.kernels.rmsnorm.kernel import (add_rmsnorm_fwd,
                                                gated_rmsnorm_fwd,
                                                qk_norm_rope_fwd, rmsnorm_fwd)
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd

torch.set_num_threads(1)


def _paged():
    return ((torch.zeros(2, 4, 1, 16), torch.zeros(8, 4, 2, 16),
             torch.zeros(8, 4, 2, 16), torch.zeros(2, 3, dtype=torch.int32),
             torch.ones(2, dtype=torch.int32)), dict(scale=1.0))


def _decode():
    return ((torch.zeros(2, 4, 1, 16), torch.zeros(2, 8, 2, 16),
             torch.zeros(2, 8, 2, 16), torch.ones(2, dtype=torch.int32)),
            dict(scale=1.0))


def _flash():
    return ((torch.zeros(2, 4, 8, 16), torch.zeros(2, 2, 8, 16),
             torch.zeros(2, 2, 8, 16)), dict(scale=1.0))


def _rmsnorm():
    return (torch.zeros(4, 32), torch.ones(32)), dict(eps=1e-6)


def _rows_pair():
    return ((torch.zeros(4, 32), torch.zeros(4, 32), torch.ones(32)),
            dict(eps=1e-6))


def _qk_rope():
    return ((torch.zeros(2, 3, 4, 16), torch.zeros(2, 3, 2, 16),
             torch.ones(16), torch.ones(16), torch.arange(3),
             torch.ones(8)), dict(eps=1e-6))


def _ssd():
    return ((torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2),
             torch.zeros(1, 8, 1, 4), torch.zeros(1, 8, 1, 4)),
            dict(chunk=4, initial_state=torch.zeros(1, 2, 4, 4)))


#: (launcher, inputs, indices of the float inputs that may require grad)
WRAPPERS = [
    (paged_attention_fwd, _paged, (0, 1, 2)),
    (decode_attention_fwd, _decode, (0, 1, 2)),
    (flash_attention_fwd, _flash, (0, 1, 2)),
    (rmsnorm_fwd, _rmsnorm, (0, 1)),
    (add_rmsnorm_fwd, _rows_pair, (0, 1, 2)),
    (gated_rmsnorm_fwd, _rows_pair, (0, 1, 2)),
    (qk_norm_rope_fwd, _qk_rope, (0, 1, 2, 3, 5)),
    (ssd_scan_fwd, _ssd, (0, 1, 2, 3)),
]
IDS = [w[0].__name__ for w in WRAPPERS]


def _with_grad(make, i):
    args, kw = make()
    args = list(args)
    args[i] = args[i].clone().requires_grad_(True)
    return args, kw


@pytest.mark.parametrize("fn,make,grad_args", WRAPPERS, ids=IDS)
def test_kernel_refuses_inputs_that_require_grad(fn, make, grad_args):
    """Every float input in turn: the launcher raises, names its kernel,
    and launches nothing."""
    for i in grad_args:
        args, kw = _with_grad(make, i)
        before = fn.launches
        with pytest.raises(RuntimeError, match=f"{fn.__name__} has no "
                                               f"backward"):
            fn(*args, **kw)
        assert fn.launches == before


@pytest.mark.parametrize("fn,make,grad_args", WRAPPERS, ids=IDS)
def test_kernel_guard_is_off_without_grad(fn, make, grad_args):
    """Under ``torch.no_grad()`` (and with no input requiring grad) the
    guard lets the call through to the device check."""
    args, kw = _with_grad(make, grad_args[0])
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, **kw)
    args, kw = make()
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args, **kw)


def test_ssd_kernel_refuses_an_initial_state_that_requires_grad():
    args, kw = _ssd()
    kw["initial_state"] = kw["initial_state"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="ssd_scan_fwd has no backward"):
        ssd_scan_fwd(*args, **kw)
