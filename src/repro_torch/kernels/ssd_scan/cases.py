"""The SSD-scan kernel's checks against its plain version: one case list
and one input generator, shared by ``chip_smoke.py`` and the card-only
tests (``tests/test_torch_gpu.py``), whose CPU counterparts feed the same
numpy inputs to the JAX package."""
from __future__ import annotations

import numpy as np
import torch

#: (name, (B, S, H, P, G, N, chunk), initial state: None, "zeros" or
#: "random"): several chunks, a ragged last chunk, S below one chunk,
#: G > 1, G == H, P and N not powers of two, an initial state, and the
#: two SSM main paths' launches as ``chip_smoke.py`` serves them (batch 8;
#: mamba2-780m's prompts of 192-384 tokens pad to 384, three chunks;
#: zamba2-2.7b's of 64-128 to 128; a prefill passes no initial state)
SSD_CASES = [
    ("multi-chunk", (2, 384, 4, 64, 1, 128, 128), None),
    ("ragged", (2, 200, 4, 64, 1, 128, 128), None),
    ("below-one-chunk", (2, 50, 4, 64, 1, 64, 128), None),
    ("groups2", (2, 96, 8, 16, 2, 32, 32), None),
    ("g-equals-h", (1, 21, 5, 8, 5, 8, 8), None),
    ("p24-n12", (2, 50, 2, 24, 2, 12, 16), None),
    ("initial-state", (2, 300, 4, 64, 1, 64, 128), "random"),
    ("zero-state", (2, 37, 3, 8, 1, 8, 16), "zeros"),
    ("mamba2-main", (8, 384, 48, 64, 1, 128, 128), None),
    ("zamba2-main", (8, 128, 80, 64, 1, 64, 128), None),
]
#: the main paths' cases by arch
SSD_MAIN = {"mamba2-780m": "mamba2-main", "zamba2-2.7b": "zamba2-main"}
#: the JAX package's own SSD tolerances (tests/test_kernels.py)
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def ssd_case(B, S, H, P, G, N, init=None, seed=0):
    """xb [B,S,H,P], a [B,S,H] (<= 0), grouped B/C [B,S,G,N] and an
    initial state [B,H,P,N] (None, zeros or random), numpy f32, from a
    seeded generator (the recipe of the JAX kernel tests)."""
    r = np.random.default_rng(seed)
    xb = r.normal(0, 0.5, (B, S, H, P)).astype(np.float32)
    a = -np.abs(r.normal(0, 0.3, (B, S, H))).astype(np.float32)
    Bm = r.normal(0, 0.5, (B, S, G, N)).astype(np.float32)
    Cm = r.normal(0, 0.5, (B, S, G, N)).astype(np.float32)
    s0 = {None: None, "zeros": np.zeros((B, H, P, N), np.float32),
          "random": r.normal(0, 0.5, (B, H, P, N)).astype(np.float32)}[init]
    return xb, a, Bm, Cm, s0


def ssd_case_on(device, dtype, B, S, H, P, G, N, init=None, seed=0):
    """``ssd_case`` as the model hands it to the kernel: xb in ``dtype``
    and contiguous (it is a product), a and the state in f32, and B and C
    in ``dtype`` as strided views into one ``[B, S, H*P + 2*G*N]`` tensor,
    the layout of ``mamba2_block``'s conv output."""
    xb, a, Bm, Cm, s0 = ssd_case(B, S, H, P, G, N, init, seed)
    xBC = np.concatenate([xb.reshape(B, S, H * P), Bm.reshape(B, S, G * N),
                          Cm.reshape(B, S, G * N)], axis=-1)
    xBC = torch.from_numpy(xBC).to(device, dtype)
    _, B_v, C_v = torch.split(xBC, [H * P, G * N, G * N], dim=-1)
    return (torch.from_numpy(xb).to(device, dtype),
            torch.from_numpy(a).to(device),
            B_v.reshape(B, S, G, N), C_v.reshape(B, S, G, N),
            None if s0 is None else torch.from_numpy(s0).to(device))
