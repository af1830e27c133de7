"""Shakeout: every smoke arch through train forward, prefill and decode.

    python -m repro_torch.tools.shakeout_models                # the card
    python -m repro_torch.tools.shakeout_models --device cpu

Each arch of ``ARCH_IDS`` at its smoke config's own dtype, random
weights from a seed: ``forward_train`` on the smoke train batch, a
prefill of the smoke prefill batch and two greedy decode steps, with no
NaN in any logits.  On the card the prefill and decode steps run the
attention, SSD-scan and RMSNorm kernels.  Prints ``OK`` or ``FAIL`` per
arch and exits non-zero on any failure.
"""
from __future__ import annotations

import argparse
import sys
import traceback

import torch

from repro_torch.configs import (ARCH_IDS, concrete_inputs, get_config,
                                 smoke_shape)
from repro_torch.models import model
from repro_torch.tools.common import device


@torch.no_grad()
def check_arch(arch: str, dev) -> str:
    """Train forward, prefill and two decode steps of ``arch``'s smoke
    config on ``dev``; raises on a NaN, returns the shapes seen."""
    cfg = get_config(arch, smoke=True)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    # --- train forward
    batch = concrete_inputs(cfg, smoke_shape("train"), device=dev)
    h, aux = model.forward_train(params, cfg, batch)
    logits = model.lm_logits(params, cfg, h)
    if torch.isnan(logits).any():
        raise AssertionError("NaN logits (train)")
    # --- prefill + decode
    pbatch = concrete_inputs(cfg, smoke_shape("prefill"), device=dev)
    pbatch.pop("labels", None), pbatch.pop("loss_mask", None)
    last, cache = model.prefill(params, cfg, pbatch, max_len=48)
    if torch.isnan(last).any():
        raise AssertionError("NaN logits (prefill)")
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    lg, cache = model.decode_step(params, cfg, cache, tok)
    lg2, cache = model.decode_step(
        params, cfg, cache, torch.argmax(lg, dim=-1).to(torch.int32))
    if torch.isnan(lg2).any():
        raise AssertionError("NaN logits (decode)")
    return (f"train {tuple(h.shape)}, prefill {tuple(last.shape)}, "
            f"decode {tuple(lg2.shape)}, len={int(cache['len'])}")


def main(argv=None) -> list:
    """Runs every arch; returns the archs that failed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    dev = device(ap.parse_args(argv).device)
    failures = []
    for arch in ARCH_IDS:
        try:
            print(f"OK   {arch}: {check_arch(arch, dev)}")
        except Exception as e:  # noqa: BLE001 - report every arch
            print(f"FAIL {arch}: {type(e).__name__}: {e}")
            traceback.print_exc()
            failures.append(arch)
    return failures


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
