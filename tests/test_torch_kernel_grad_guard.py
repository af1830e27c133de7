"""A bare launcher records nothing for autograd, so each of the nine
forward launchers (and the four RMSNorm backward launchers, and the four
of the gated norm split over ranks) refuses an
input that requires grad while grad is enabled, before it looks at the
device (so these run on the CPU).  Without grad the same call goes on to
the launcher's own checks, which refuse a CPU tensor.

The RMSNorm ops are ``torch.autograd.Function``s on the card (the forward
kernel, then the backward kernel): they accept inputs that require grad
and return a ``grad_fn``.  On the CPU the ops trace the plain version;
a Function's own forward runs with grad off, so its launcher's guard lets
it through to the device check.  The split gated norm's op takes the sum
over the ranks as a function; its Function does the same."""
import pytest
import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.paged_attention.kernel import paged_attention_fwd
from repro_torch.kernels.paged_prefill.kernel import paged_prefill_fwd
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.kernel import (add_rmsnorm_bwd,
                                                add_rmsnorm_fwd,
                                                gated_rmsnorm_bwd,
                                                gated_rmsnorm_dot,
                                                gated_rmsnorm_fwd,
                                                gated_rmsnorm_scale,
                                                gated_rmsnorm_scale_bwd,
                                                gated_rmsnorm_sumsq,
                                                qk_norm_rope_bwd,
                                                qk_norm_rope_fwd, rmsnorm_bwd,
                                                rmsnorm_fwd)
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd

torch.set_num_threads(1)


def _paged():
    return ((torch.zeros(2, 4, 1, 16), torch.zeros(8, 4, 2, 16),
             torch.zeros(8, 4, 2, 16), torch.zeros(2, 3, dtype=torch.int32),
             torch.ones(2, dtype=torch.int32)), dict(scale=1.0))


def _prefill():
    return ((torch.zeros(2, 8, 4, 16), torch.zeros(8, 4, 2, 16),
             torch.zeros(8, 4, 2, 16), torch.zeros(2, 3, dtype=torch.int32),
             torch.zeros(2, dtype=torch.int32),
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


def _rms_bwd():
    return (torch.zeros(4, 32), torch.zeros(4, 32), torch.ones(32)), \
        dict(eps=1e-6)


def _add_bwd():
    return ((torch.zeros(4, 32), torch.zeros(4, 32), torch.zeros(4, 32),
             torch.ones(32)), dict(eps=1e-6))


def _gated_bwd():
    return ((torch.zeros(4, 32), torch.zeros(4, 32), torch.zeros(4, 32),
             torch.ones(32)), dict(eps=1e-6))


def _qk_bwd():
    (q, k, wq, wk, pos, freq), kw = _qk_rope()
    return (torch.zeros(2, 3, 4, 16), torch.zeros(2, 3, 2, 16), q, k, wq,
            wk, pos, freq), kw


def _sumsq():
    return (torch.zeros(4, 32), torch.zeros(4, 32)), {}


def _scale():
    return ((torch.zeros(4, 32), torch.zeros(4, 32), torch.ones(32),
             torch.ones(4)), dict(d_total=64, eps=1e-6))


def _dot():
    return ((torch.zeros(4, 32), torch.zeros(4, 32), torch.zeros(4, 32),
             torch.ones(32)), {})


def _scale_bwd():
    return ((torch.zeros(4, 32), torch.zeros(4, 32), torch.zeros(4, 32),
             torch.ones(32), torch.ones(4), torch.zeros(4)),
            dict(d_total=64, eps=1e-6))


#: (launcher, inputs, indices of the float inputs that may require grad)
WRAPPERS = [
    (paged_attention_fwd, _paged, (0, 1, 2)),
    (paged_prefill_fwd, _prefill, (0, 1, 2)),
    (decode_attention_fwd, _decode, (0, 1, 2)),
    (flash_attention_fwd, _flash, (0, 1, 2)),
    (rmsnorm_fwd, _rmsnorm, (0, 1)),
    (add_rmsnorm_fwd, _rows_pair, (0, 1, 2)),
    (gated_rmsnorm_fwd, _rows_pair, (0, 1, 2)),
    (qk_norm_rope_fwd, _qk_rope, (0, 1, 2, 3, 5)),
    (ssd_scan_fwd, _ssd, (0, 1, 2, 3)),
    (rmsnorm_bwd, _rms_bwd, (0, 1, 2)),
    (add_rmsnorm_bwd, _add_bwd, (0, 1, 2, 3)),
    (gated_rmsnorm_bwd, _gated_bwd, (0, 1, 2, 3)),
    (qk_norm_rope_bwd, _qk_bwd, (0, 1, 2, 3, 4, 5, 7)),
    (gated_rmsnorm_sumsq, _sumsq, (0, 1)),
    (gated_rmsnorm_scale, _scale, (0, 1, 2, 3)),
    (gated_rmsnorm_dot, _dot, (0, 1, 2, 3)),
    (gated_rmsnorm_scale_bwd, _scale_bwd, (0, 1, 2, 3, 4, 5)),
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


#: (op, its autograd Function, inputs, indices of the float inputs)
NORM_OPS = [
    ("rmsnorm", rms_ops.RMSNormFn, _rmsnorm, (0, 1)),
    ("add_rmsnorm", rms_ops.AddRMSNormFn, _rows_pair, (0, 1, 2)),
    ("gated_rmsnorm", rms_ops.GatedRMSNormFn, _rows_pair, (0, 1, 2)),
    ("qk_norm_rope", rms_ops.QKNormRopeFn, _qk_rope, (0, 1, 2, 3)),
]


def _op_args(op, args):
    """The op's own arguments from its launcher's."""
    if op == "qk_norm_rope":
        q, k, wq, wk, pos, _ = args
        return (q, k, wq, wk, pos, 1e6, 1e-6)
    return (*args, 1e-6)


@pytest.mark.parametrize("op,fn,make,grad_args", NORM_OPS,
                         ids=[n[0] for n in NORM_OPS])
def test_norm_ops_accept_inputs_that_require_grad(op, fn, make, grad_args):
    """Every float input in turn requiring grad: the op returns its
    outputs that depend on it with a ``grad_fn`` (the plain version on the
    CPU) and the input gets a gradient, and its
    Function's forward (grad off inside it) passes its launcher's grad
    guard and reaches the device check, which refuses a CPU tensor: on
    the card it launches.  The bare launcher refuses the same inputs."""
    launcher = getattr(rms_ops, f"{op}_fwd")
    for i in grad_args:
        args, _ = _with_grad(make, i)
        outs = getattr(rms_ops, op)(*_op_args(op, args))
        outs = outs if isinstance(outs, tuple) else (outs,)
        # an output that does not depend on the input (r on w; k' on wq)
        # needs no graph
        tracked = [o for o in outs if o.grad_fn is not None]
        assert tracked
        sum(o.sum() for o in tracked).backward()
        assert args[i].grad is not None
        args, kw = _with_grad(make, i)
        with pytest.raises(ValueError, match="CUDA"):
            fn.apply(*args, 1e-6)
        with pytest.raises(RuntimeError, match="has no backward"):
            launcher(*args, **kw)


def test_split_gated_norm_op_accepts_inputs_that_require_grad():
    """``gated_rmsnorm_split`` on the CPU traces the plain version (the
    gradient reaches y, z and w through ``reduce``), and its Function's
    forward passes the launchers' grad guard and reaches the device
    check; the bare launchers refuse the same inputs."""
    (y, z, w), _ = _rows_pair()
    for i in range(3):
        args = [y.clone(), z.clone(), w.clone()]
        args[i].requires_grad_(True)
        out = rms_ops.gated_rmsnorm_split(*args, 64, lambda t: t * 2, 1e-6)
        assert out.grad_fn is not None
        out.sum().backward()
        assert args[i].grad is not None
        with pytest.raises(ValueError, match="CUDA"):
            rms_ops.GatedRMSNormSplitFn.apply(*args, 1e-6, 64, lambda t: t)
    with pytest.raises(RuntimeError, match="has no backward"):
        gated_rmsnorm_sumsq(y.clone().requires_grad_(True), z)
