"""The RMSNorm kernel's checks against its plain version: one case list
and one input generator, shared by ``chip_smoke.py`` and the card-only
tests (``tests/test_torch_gpu.py``), whose CPU counterparts feed the same
numpy inputs to the JAX package."""
from __future__ import annotations

import numpy as np
import torch

#: (name, x shape, layout): every model width (d 128 for the qk-norm; 1024,
#: 1536, 2048 and 2560 for the block and final norms; 3072 and 5120 for
#: Mamba2's gated norm), small d (16, 48, 80), d not a multiple of the
#: 16-byte vector (one element per load, in warp and in block mode), row
#: counts of 1, 7, 8 and 1024, one to three leading axes, and three
#: layouts: "dense"; "row-stride", x the first d columns of a wider
#: tensor (a 2-D view read through its row stride; "+3" makes the stride
#: break the 16-byte vector); "last-token", x = h[:, -1:] of [B, 5, d]
#: (the dense prefill's final norm)
RMSNORM_CASES = [
    ("d16-rows1", (1, 16), "dense"),
    ("d48-rows7", (7, 48), "dense"),
    ("d80-rows8", (8, 80), "dense"),
    ("d128-qk-norm", (8, 1, 16, 128), "dense"),
    ("d128-rows1024", (1024, 128), "dense"),
    ("d1024-rows1024", (1024, 1024), "dense"),
    ("d1536-lead3", (2, 4, 1, 1536), "dense"),
    ("d2048-rows8", (8, 1, 2048), "dense"),
    ("d2560-rows7", (7, 2560), "dense"),
    ("d3072-rows8", (8, 3072), "dense"),
    ("d5120-gated", (8, 128, 5120), "dense"),
    ("d5120-rows1", (1, 5120), "dense"),
    ("d20-odd", (7, 20), "dense"),
    ("d100-odd", (8, 1, 100), "dense"),
    ("d1030-odd-block", (3, 1030), "dense"),
    ("d2048-row-stride", (8, 2048), "row-stride"),
    ("d1024-row-stride+3", (7, 1024), "row-stride+3"),
    ("d1024-last-token", (8, 1, 1024), "last-token"),
]
#: (x dtype, w dtype): the model's bf16 and f32 trees, and both mixes
RMSNORM_DTYPES = [(torch.float32, torch.float32),
                  (torch.bfloat16, torch.bfloat16),
                  (torch.bfloat16, torch.float32),
                  (torch.float32, torch.bfloat16)]
#: the paths' shapes that ``chip_smoke.py`` times, by name: (x shape)
RMSNORM_TIMED = {
    "qwen3-0.6b decode": (8, 1, 1024),
    "qwen3-0.6b qk-norm": (8, 1, 16, 128),
    "qwen3-moe decode": (8, 1, 2048),
    "qwen3-moe qk-norm": (8, 1, 32, 128),
    "zamba2 gated norm": (8, 128, 5120),
}


def rmsnorm_case(shape, layout="dense", seed=0):
    """x of ``shape`` in the case's layout (numpy f32: the full array it
    is a view of, and how to take the view) and w [d], from a seeded
    generator."""
    r = np.random.default_rng(seed)
    d = shape[-1]
    pad = {"dense": 0, "row-stride": 8, "row-stride+3": 3,
           "last-token": 0}[layout]
    full = shape[:-1] + (d + pad,)
    if layout == "last-token":
        full = (shape[0], 5) + shape[2:]
    x = r.normal(0, 2, full).astype(np.float32)
    w = r.normal(1, 0.1, (d,)).astype(np.float32)
    return x, w


def rmsnorm_case_on(device, x_dtype, w_dtype, shape, layout="dense",
                    seed=0):
    """``rmsnorm_case`` on ``device``: x in ``x_dtype`` as the case's view
    (of shape ``shape``), w in ``w_dtype``."""
    x, w = rmsnorm_case(shape, layout, seed)
    xt = torch.from_numpy(x).to(device, x_dtype)
    if layout == "last-token":
        xt = xt[:, -1:]
    elif layout != "dense":
        xt = xt[..., :shape[-1]]
    assert tuple(xt.shape) == tuple(shape)
    return xt, torch.from_numpy(w).to(device, w_dtype)
