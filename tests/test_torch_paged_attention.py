"""The port's paged-attention plain versions against the JAX package's,
including the JAX Pallas paged kernel in interpret mode (f32, CPU, atol
2e-5 as in the JAX kernel tests: both sides accumulate in f32 in a
different order).  The CUDA kernel is held against the plain version by
tests/test_torch_gpu.py (run on a card) and by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import paged_attention as j_pallas
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as j_paged_ref
from repro.models import attention as ja
from repro_torch.kernels.paged_attention import ops as t_ops
from repro_torch.kernels.paged_attention.kernel import paged_attention_fwd
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_ref as t_paged_ref
from repro_torch.models import attention as ta
from test_torch_gpu import PAGED_CASES
from test_torch_gpu import paged_case as _paged_case

torch.set_num_threads(1)
ATOL = 2e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("case,window,cap", PAGED_CASES)
def test_paged_ref_vs_jax_ref_and_pallas(case, window, cap):
    B, P, page, Hq, Hkv, D, lens = case
    q, kp, vp, table, ln = _paged_case(B, P, page, Hq, Hkv, D, lens)
    scale = D ** -0.5
    t = t_paged_ref(torch.from_numpy(q).transpose(1, 2),
                    torch.from_numpy(kp), torch.from_numpy(vp),
                    torch.from_numpy(table), torch.from_numpy(ln),
                    scale=scale, window=window, softcap=cap)
    j_ref = j_paged_ref(jnp.moveaxis(jnp.asarray(q), 2, 1), jnp.asarray(kp),
                        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(ln),
                        scale=scale, window=window, softcap=cap)
    _close(t, j_ref)
    # the Pallas kernel itself, in interpret mode (the default off-TPU)
    j_ker = j_pallas(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                     jnp.asarray(table), jnp.asarray(ln), window=window,
                     attn_softcap=cap)
    _close(t.transpose(1, 2), j_ker)


def test_paged_ops_cpu_is_plain_version():
    """On a CPU tensor the wrapper runs the plain version and never
    touches the kernel (whose launch count stays put)."""
    q, kp, vp, table, ln = _paged_case(2, 16, 8, 4, 2, 16, [11, 29])
    before = paged_attention_fwd.launches
    out = t_ops.paged_attention(*(torch.from_numpy(a)
                                  for a in (q, kp, vp, table, ln)))
    ref = t_paged_ref(torch.from_numpy(q).transpose(1, 2),
                      torch.from_numpy(kp), torch.from_numpy(vp),
                      torch.from_numpy(table), torch.from_numpy(ln),
                      scale=16 ** -0.5).transpose(1, 2)
    assert torch.equal(out, ref)
    assert paged_attention_fwd.launches == before


def test_paged_kernel_launcher_rejects_cpu_tensors():
    q, kp, vp, table, ln = (torch.from_numpy(a) for a in
                            _paged_case(1, 4, 4, 2, 1, 8, [3]))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_fwd(q.transpose(1, 2), kp, vp, table, ln, scale=1.0)


def test_paged_decode_attention_cpu_vs_jax():
    q, kp, vp, table, ln = _paged_case(2, 16, 8, 4, 2, 16, [11, 29], seed=3)
    t = ta.paged_decode_attention(*(torch.from_numpy(a)
                                    for a in (q, kp, vp, table, ln)),
                                  scale=0.2)
    j = ja.paged_decode_attention(*(jnp.asarray(a)
                                    for a in (q, kp, vp, table, ln)),
                                  scale=0.2)
    _close(t, j)


def _launcher_args(B=2, P=8, page=4, Hq=4, Hkv=2, D=16, maxp=3):
    return dict(q=torch.zeros(B, Hq, 1, D), k_pool=torch.zeros(P, page, Hkv, D),
                v_pool=torch.zeros(P, page, Hkv, D),
                page_table=torch.zeros(B, maxp, dtype=torch.int32),
                lens=torch.ones(B, dtype=torch.int32))


@pytest.mark.parametrize("bad,exc,match", [
    (dict(q=torch.zeros(2, 4, 2, 16)), ValueError, "q must be"),
    (dict(v_pool=torch.zeros(8, 4, 2, 8)), ValueError, "pools must"),
    (dict(q=torch.zeros(2, 3, 1, 16)), ValueError, "multiple of"),
    (dict(q=torch.zeros(2, 4, 1, 12), k_pool=torch.zeros(8, 4, 2, 12),
          v_pool=torch.zeros(8, 4, 2, 12)), ValueError, "head dim 12"),
    (dict(q=torch.zeros(2, 4, 1, 264), k_pool=torch.zeros(8, 4, 2, 264),
          v_pool=torch.zeros(8, 4, 2, 264)), ValueError, "head dim 264"),
    (dict(page_table=torch.zeros(3, 3, dtype=torch.int32)), ValueError,
     "page_table must"),
    (dict(lens=torch.ones(3, dtype=torch.int32)), ValueError, "lens must"),
    (dict(q=torch.zeros(2, 4, 1, 16, dtype=torch.float16)), TypeError,
     "float32/bfloat16"),
    (dict(lens=torch.ones(2, dtype=torch.int64)), TypeError, "int32"),
], ids=["q-rank", "pool-shape", "gqa", "d-not-8", "d-too-big", "table-rows",
        "lens-shape", "dtype", "index-dtype"])
def test_paged_kernel_launcher_rejects_what_it_does_not_take(bad, exc, match):
    """The launcher refuses shapes and types the kernel does not take
    before it looks at the device (so this runs without a card)."""
    args = _launcher_args()
    args.update(bad)
    with pytest.raises(exc, match=match):
        paged_attention_fwd(**args, scale=1.0)


def test_paged_kernel_shared_memory_fits_the_main_path():
    """fp32 K and V pages, q and acc for the group, scores and (m, l, a):
    the main path (G=2, D=128, page=16) stays under the 48 KB default."""
    from repro_torch.kernels.paged_attention.kernel import smem_bytes
    assert smem_bytes(2, 128, 16) == 4 * (2 * 16 * 128 + 2 * 2 * 128
                                          + 2 * 16 + 3 * 2)
    assert smem_bytes(2, 128, 16) < 48 * 1024


def test_kernel_build_helpers(tmp_path):
    """Every kernel source is found, and a library's name follows its
    source's content (an edited source is rebuilt, never reused)."""
    from repro_torch.kernels import build
    srcs = build.sources()
    assert [s.name for s in srcs] == ["paged_attention.cu"]
    a = tmp_path / "k.cu"
    a.write_text("// one")
    first = build.library_path(a)
    assert first.parent == build.BUILD_DIR and first.suffix == ".so"
    a.write_text("// two")
    assert build.library_path(a) != first
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
