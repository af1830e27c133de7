"""Mamba2 dimensions.  Only the shape arithmetic that ``param_specs`` and
``init_cache`` need lives here for now; the SSM blocks themselves come
with the SSM/hybrid slice."""
from __future__ import annotations


def mamba2_dims(cfg) -> dict:
    di = cfg.d_inner
    H = cfg.ssm_heads
    G, N = cfg.ssm_groups, cfg.ssm_state
    conv_ch = di + 2 * G * N
    return dict(di=di, H=H, G=G, N=N, P=cfg.ssm_head_dim, conv_ch=conv_ch,
                in_dim=2 * di + 2 * G * N + H)
