"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates
without sparsity), at its full 700 W; ``power_limit`` reads the card's
own limit, which is printed beside every share of these peaks."""
from __future__ import annotations

import subprocess

#: bf16 on the tensor cores
BF16_FLOPS = 989e12
#: fp32 outside the tensor cores (TF32 off)
F32_FLOPS = 67e12
#: HBM3
HBM_BYTES_S = 3.35e12


def power_limit() -> str:
    """``name, power.limit`` of card 0 as ``nvidia-smi`` reads them, or
    "not read" where it cannot run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip() or "not read"
