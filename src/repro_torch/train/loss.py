"""Next-token cross-entropy over fp32 logits, mirroring the JAX package's
``train/loss.py``.

Optional sequence chunking splits the logits into ``seq_chunks`` pieces,
each normed and projected by its own ``lm_logits`` call, as the JAX
function does.  In eager PyTorch autograd keeps every chunk's logits for
the backward, so chunking does not lower the peak here (ROADMAP.md,
training-speed work).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import model as model_lib


def _ce_from_hidden(params, cfg, hidden, labels, mask):
    logits = model_lib.lm_logits(params, cfg, hidden)  # [B,S,V] fp32
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return torch.sum(nll), torch.sum(mask)


def lm_loss(params, cfg, hidden: torch.Tensor, labels: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None,
            seq_chunks: int = 1) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE. hidden: [B,S,d]; labels: [B,S] (already shifted by
    the data pipeline: labels[t] = target for position t)."""
    B, S, _ = hidden.shape
    mask = (torch.ones((B, S), dtype=torch.float32, device=hidden.device)
            if loss_mask is None else loss_mask.float())
    if seq_chunks > 1 and S % seq_chunks == 0:
        c = S // seq_chunks
        tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(seq_chunks):
            t, n = _ce_from_hidden(params, cfg,
                                   hidden[:, i * c:(i + 1) * c],
                                   labels[:, i * c:(i + 1) * c],
                                   mask[:, i * c:(i + 1) * c])
            tot, cnt = tot + t, cnt + n
    else:
        tot, cnt = _ce_from_hidden(params, cfg, hidden, labels, mask)
    denom = torch.clamp(cnt, min=1.0)
    loss = tot / denom
    return loss, {"ce_loss": loss, "tokens": cnt}
