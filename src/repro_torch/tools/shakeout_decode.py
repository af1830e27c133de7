"""Check: prefill(t[:k]) + decode(t[k:]) logits == full forward logits.

    python -m repro_torch.tools.shakeout_decode                # the card
    python -m repro_torch.tools.shakeout_decode --device cpu

Six smoke archs in f32, random weights from a seed: the logits of a
prefill of the first 10 tokens and of 6 decode steps must lie within
``TOL`` of ``forward_train``'s at each position (the MoE arch at a
capacity at which no call drops an assignment: ``no_drop_factor``).
On the card the prefill runs the flash and SSD-scan kernels, the decode
steps the dense decode kernel, and every norm its RMSNorm kernel;
``forward_train`` takes the plain attention and scan.  Prints ``OK`` or
``FAIL`` per arch and exits non-zero on any failure.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import model
from repro_torch.tools.common import device

ARCHS = ["qwen3-14b", "gemma2-27b", "qwen3-moe-30b-a3b", "mamba2-780m",
         "zamba2-2.7b", "whisper-large-v3"]
TOL = 2e-3


def no_drop_factor(cfg) -> float:
    """A capacity factor at which no MoE call drops an assignment (each
    expert's capacity C = the call's tokens).  ``forward_train`` routes
    32 tokens, the prefill 20 and a decode step 2: at the config's own
    factor each call drops other assignments past its experts' capacity,
    so the three compute different functions (the JAX package's script
    fails on qwen3-moe-30b-a3b for that, max |logit diff| 4.74e-1 on the
    CPU).  At this factor they compute the same one."""
    return cfg.num_experts / cfg.experts_per_token


@torch.no_grad()
def check_arch(arch: str, dev) -> float:
    """The largest |logit difference| of ``arch``'s prefill and decode
    steps against ``forward_train`` on ``dev``."""
    cfg = get_config(arch, smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=no_drop_factor(cfg))
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    rng = np.random.default_rng(0)
    B, S, K = 2, 16, 10  # prefill first K, decode the rest
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)

    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(rng.normal(
            0, 0.1, (B, 8, cfg.d_model)).astype(np.float32)).to(dev)

    # full forward logits at each position
    h, _ = model.forward_train(params, cfg, batch)
    full_logits = model.lm_logits(params, cfg, h)  # [B, S, V]

    pb = dict(batch)
    pb["tokens"] = tokens[:, :K]
    last, cache = model.prefill(params, cfg, pb, max_len=S + 4)
    errs = [(last[:, 0] - full_logits[:, K - 1]).abs().max().item()]
    for i in range(K, S):
        lg, cache = model.decode_step(params, cfg, cache, tokens[:, i:i + 1])
        errs.append((lg[:, 0] - full_logits[:, i]).abs().max().item())
    return max(errs)


def main(argv=None) -> list:
    """Runs every arch; returns the archs that failed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    dev = device(ap.parse_args(argv).device)
    failures = []
    for arch in ARCHS:
        worst = check_arch(arch, dev)
        ok = worst < TOL
        print(f"{'OK  ' if ok else 'FAIL'} {arch}: max |logit diff| = "
              f"{worst:.2e}")
        if not ok:
            failures.append(arch)
    return failures


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
