"""Next-token cross-entropy over fp32 logits, mirroring the JAX package's
``train/loss.py``.

Under the tensor-parallel context (``models/tp.py``) the CE runs over
this rank's vocabulary columns (``vocab_lse_gold``).

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
from repro_torch.models.tp import vocab_lse_gold


def _ce_from_hidden(params, cfg, hidden, labels, mask):
    # [B,S,V] fp32, or this rank's [B,S,V/M] under the tensor-parallel
    # context: no [B,S,V] is gathered
    logits = model_lib.lm_logits(params, cfg, hidden)
    lse, gold = vocab_lse_gold(logits, labels, cfg.vocab_size)
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
