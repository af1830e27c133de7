"""The port's SSD-scan plain version against the JAX package's: its jnp
oracle (``ssd_scan_ref``) and its Pallas kernel in interpret mode (the
default off-TPU), at the JAX package's own SSD tolerances (f32 1e-4,
bf16 5e-2).  The cases mirror the JAX kernel tests: a ragged last
chunk, several chunks, G > 1, G == H, P and N not powers of two, an
initial state, and chunk invariance.  The CUDA kernel is held against
the plain version by tests/test_torch_gpu.py (run on a card) and by
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as j_pallas
from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_ref
from repro_torch.kernels.ssd_scan import ops as t_ops
from repro_torch.kernels.ssd_scan.cases import (SSD_CASES, ssd_case,
                                                ssd_case_on)
from repro_torch.kernels.ssd_scan.kernel import (MAX_SMEM, ROWS, smem_bytes,
                                                 ssd_scan_fwd)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref as t_ref
from repro_torch.models import ssm as t_ssm

torch.set_num_threads(1)


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


#: (B, S, H, P, G, N, chunk): tests/test_kernels.py's sweeps
CASES = [
    (2, 48, 4, 8, 2, 8, 16),     # three whole chunks, G = 2
    (1, 40, 2, 16, 1, 32, 16),   # ragged last chunk (padded in JAX)
    (1, 37, 3, 8, 1, 8, 16),     # odd S, odd H
    (2, 50, 2, 24, 2, 12, 16),   # P = 24, N = 12
    (1, 21, 5, 8, 5, 8, 8),      # S barely above 2 chunks, G == H
    (2, 9, 2, 8, 1, 8, 16),      # S below one chunk
]


@pytest.mark.parametrize("case", CASES)
def test_ssd_ref_vs_jax_oracle_and_pallas(case):
    B, S, H, P, G, N, chunk = case
    xb, a, Bm, Cm, _ = ssd_case(B, S, H, P, G, N, seed=1)
    y, st = t_ref(*(torch.from_numpy(t) for t in (xb, a, Bm, Cm)),
                  chunk=chunk)
    assert y.shape == (B, S, H, P) and st.shape == (B, H, P, N)
    jarg = [jnp.asarray(t) for t in (xb, a, Bm, Cm)]
    yj, sj = j_ref(*jarg, chunk=chunk)
    _close(y, yj, 1e-4)
    _close(st, sj, 1e-4)
    yk, sk = j_pallas(*jarg, chunk=chunk)       # the Pallas kernel
    _close(y, yk, 1e-4)
    _close(st, sk, 1e-4)


@pytest.mark.parametrize("case", CASES[2:5])
def test_ssd_ref_bf16_vs_jax_oracle(case):
    """bf16 inputs: y comes back in bf16 (cast once, after fp32 sums) and
    the state in fp32, as in the JAX oracle."""
    B, S, H, P, G, N, chunk = case
    xb, a, Bm, Cm, _ = ssd_case(B, S, H, P, G, N, seed=2)
    targs = [torch.from_numpy(t).to(torch.bfloat16) for t in (xb, a, Bm, Cm)]
    y, st = t_ref(*targs, chunk=chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    yj, sj = j_ref(*(jnp.asarray(t, jnp.bfloat16) for t in (xb, a, Bm, Cm)),
                   chunk=chunk)
    _close(y, yj, 5e-2)
    _close(st, sj, 5e-2)


def test_ssd_initial_state_vs_jax():
    """An initial state is the state the first chunk starts from, as in
    the JAX oracle (and in the CUDA kernel).  The JAX Pallas wrapper folds
    it in after its kernel instead: in f32 the two agree to 1e-4 (in
    bf16 they differ by one rounding of y, the documented difference)."""
    B, S, H, P, G, N, chunk = 1, 40, 2, 8, 1, 16, 16
    xb, a, Bm, Cm, s0 = ssd_case(B, S, H, P, G, N, init="random", seed=3)
    y, st = t_ref(*(torch.from_numpy(t) for t in (xb, a, Bm, Cm)),
                  chunk=chunk, initial_state=torch.from_numpy(s0))
    jarg = [jnp.asarray(t) for t in (xb, a, Bm, Cm)]
    for fn in (j_ref, j_pallas):
        yj, sj = fn(*jarg, chunk=chunk, initial_state=jnp.asarray(s0))
        _close(y, yj, 1e-4)
        _close(st, sj, 1e-4)


def test_ssd_zero_initial_state_is_no_initial_state():
    """A zero state is exactly no state (a prefill, whose cache is fresh,
    passes none)."""
    xb, a, Bm, Cm, s0 = ssd_case(2, 37, 3, 8, 1, 8, init="zeros", seed=4)
    args = [torch.from_numpy(t) for t in (xb, a, Bm, Cm)]
    y0, s_0 = t_ref(*args, chunk=16)
    y1, s_1 = t_ref(*args, chunk=16, initial_state=torch.from_numpy(s0))
    assert torch.equal(y0, y1) and torch.equal(s_0, s_1)


def test_ssd_chunk_invariance():
    """Same result regardless of chunk size (associativity of the scan)."""
    xb, a, Bm, Cm, _ = ssd_case(1, 64, 2, 8, 1, 8, seed=5)
    args = [torch.from_numpy(t) for t in (xb, a, Bm, Cm)]
    y16, s16 = t_ref(*args, chunk=16)
    y32, s32 = t_ref(*args, chunk=32)
    y64, s64 = t_ref(*args, chunk=64)
    for y, s in ((y32, s32), (y64, s64)):
        torch.testing.assert_close(y, y16, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(s, s16, atol=1e-4, rtol=1e-4)


def test_ssd_ops_cpu_is_plain_version_and_the_device_decides():
    """On a CPU tensor the wrapper (and the model's ``ssd_chunked``)
    runs the plain version and never touches the kernel; a tensor on
    another device is refused, not routed anywhere."""
    xb, a, Bm, Cm, s0 = ssd_case(2, 37, 3, 8, 1, 8, init="random", seed=6)
    args = [torch.from_numpy(t) for t in (xb, a, Bm, Cm)]
    init = torch.from_numpy(s0)
    before = ssd_scan_fwd.launches
    y, st = t_ops.ssd_scan(*args, chunk=16, initial_state=init)
    ym, sm = t_ssm.ssd_chunked(*args, chunk=16, initial_state=init,
                               use_pallas=True)
    assert ssd_scan_fwd.launches == before
    yr, sr = t_ref(*args, chunk=16, initial_state=init)
    for got, want in ((y, yr), (st, sr), (ym, yr), (sm, sr)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_ops.ssd_scan(*(t.to("meta") for t in args), chunk=16)


def _launcher_args(B=2, S=8, H=4, P=8, G=2, N=16):
    return dict(xb=torch.zeros(B, S, H, P), a=torch.zeros(B, S, H),
                B_mat=torch.zeros(B, S, G, N), C_mat=torch.zeros(B, S, G, N))


@pytest.mark.parametrize("bad,kw,exc,match", [
    (dict(xb=torch.zeros(2, 8, 4)), {}, ValueError, "xb must be"),
    (dict(a=torch.zeros(2, 8, 3)), {}, ValueError, "a must be"),
    (dict(C_mat=torch.zeros(2, 8, 2, 8)), {}, ValueError, "B and C must"),
    (dict(B_mat=torch.zeros(2, 8, 3, 16), C_mat=torch.zeros(2, 8, 3, 16)),
     {}, ValueError, "multiple of G"),
    (dict(), dict(chunk=0), ValueError, "chunk must"),
    (dict(xb=torch.zeros(2, 8, 4, 8, dtype=torch.float16)), {}, TypeError,
     "float32/bfloat16"),
    (dict(a=torch.zeros(2, 8, 4, dtype=torch.bfloat16)), {}, TypeError,
     "a must be float32"),
    (dict(), dict(initial_state=torch.zeros(2, 4, 8, 8)), ValueError,
     "initial_state must be"),
    (dict(), dict(initial_state=torch.zeros(2, 4, 8, 16,
                                            dtype=torch.bfloat16)),
     TypeError, "initial_state must be float32"),
    (dict(), {}, ValueError, "CUDA"),
    (dict(), dict(chunk=1024), ValueError, "shared memory"),
], ids=["xb-rank", "a-shape", "bc-shape", "groups", "chunk", "dtype",
        "a-dtype", "state-shape", "state-dtype", "cpu-tensor", "smem"])
def test_ssd_kernel_launcher_rejects_what_it_does_not_take(bad, kw, exc,
                                                           match):
    """The launcher refuses shapes, types and devices the kernel does not
    take before it builds anything (so this runs without a card)."""
    args = _launcher_args()
    args.update(bad)
    with pytest.raises(exc, match=match):
        ssd_scan_fwd(**args, **{"chunk": 4, **kw})


def test_ssd_kernel_shared_memory():
    """fp32 state, B chunk (rows padded to N + 1), xb chunk, a tile of C
    rows and scores, cumsum and decay: 164 KB at mamba2-780m's chunk 128,
    N 128, P 64 and 108 KB at zamba2-2.7b's N 64 -- above the 48 KB
    default (the launcher raises the limit) and under Hopper's 227 KB."""
    assert ROWS == 32
    m = smem_bytes(128, 64, 128)
    assert m == 4 * (64 * 129 + 128 * 129 + 128 * 64 + 32 * 129 + 32 * 128
                     + 2 * 128)
    assert 48 * 1024 < smem_bytes(128, 64, 64) < m < MAX_SMEM


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: c[0])
def test_ssd_route_takes_the_tensor_cores_for_every_bf16_case(case):
    """The route is a rule on dtype and shape alone: every bf16 case of
    the card's case list (both served launches among them) takes the
    tensor cores, every f32 case the CUDA cores; the tensor-core layout
    fits in shared memory with room to spare."""
    from repro_torch.kernels.ssd_scan.kernel import (CUDA_CORES,
                                                     TENSOR_CORES, route)
    _, (B, S, H, P, G, N, chunk), _ = case
    assert route(torch.bfloat16, chunk, P, N) == TENSOR_CORES
    assert route(torch.float32, chunk, P, N) == CUDA_CORES
    assert smem_bytes(chunk, P, N, TENSOR_CORES) <= MAX_SMEM


@pytest.mark.parametrize("chunk,P,N", [(256, 64, 128), (128, 80, 64),
                                       (64, 64, 256)])
def test_ssd_route_past_the_tensor_core_limits(chunk, P, N):
    """A bf16 launch past a tile of 128 chunk rows, a panel of 64 P
    columns or two of N takes the CUDA cores."""
    from repro_torch.kernels.ssd_scan.kernel import CUDA_CORES, route
    assert route(torch.bfloat16, chunk, P, N) == CUDA_CORES


def test_ssd_tensor_core_shared_memory():
    """1 KB of alignment slack, two ring stages of bf16 C and B (128 x N
    rounded up to 64 or 128) and xb (128 x 64), the scaled xb, the
    state's bf16 copy (64 x Np), a and its cumsum: 194 KB at mamba2-780m's
    N 128, 121 KB at zamba2-2.7b's N 64, so one block per SM either way."""
    from repro_torch.kernels.ssd_scan.kernel import TENSOR_CORES
    m = smem_bytes(128, 64, 128, TENSOR_CORES)
    assert m == 1024 + 2 * (2 * 128 * 128 * 2 + 128 * 128) + 128 * 128 \
        + 64 * 128 * 2 + 2 * 128 * 4
    z = smem_bytes(128, 64, 64, TENSOR_CORES)
    assert z == 1024 + 2 * (2 * 128 * 64 * 2 + 128 * 128) + 128 * 128 \
        + 64 * 64 * 2 + 2 * 128 * 4
    assert MAX_SMEM // 2 < z < m < MAX_SMEM
    assert smem_bytes(8, 8, 8, TENSOR_CORES) == z   # N 8 rounds up to 64


@pytest.mark.parametrize("name,want", [
    ("mamba2-main", True), ("zamba2-main", True), ("groups2", True),
    ("g-equals-h", True), ("p24-n12", False)])
def test_ssd_tensor_core_tiles_by_cp_async_where_rows_align(name, want):
    """The tiles are filled by 16-byte cp.async only where every row of
    xb, B and C starts on 16 bytes; the served views of the conv output
    do, and N = 12 does not (its tiles are filled element by element)."""
    from repro_torch.kernels.ssd_scan.kernel import vectorized
    _, (B, S, H, P, G, N, chunk), init = next(c for c in SSD_CASES
                                              if c[0] == name)
    xb, _, Bm, Cm, _ = ssd_case_on("cpu", torch.bfloat16, B, S, H, P, G, N,
                                   init)
    assert vectorized(xb, Bm, Cm) is want
