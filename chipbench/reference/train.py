"""Three training steps of the plain reference: the next-token
cross-entropy of an architecture's reference module (``ref``: its
``block``, ``head_weight`` and ``final_logits``) over a batch, its
gradients by autograd, and AdamW (Loshchilov & Hutter) with the
gradients clipped to a global norm first, decoupled weight decay scaled
by the learning rate, and the learning rate on a linear warm-up then a
cosine to a tenth of its peak.
All of it in float32 with TF32 off; the parameters are kept between
steps in the type the configuration stores them in (bf16: no float32
master copy), the moments in float32, as the configuration states.
Each layer, and each block of rows of the LM head and loss, is
recomputed in the backward, so a 16 x 1,024 batch fits."""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint


def leaves(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _ce_rows(h, labels, final_w, head, ref, dm, quant):
    logits = ref.final_logits(h, final_w, head, dm, quant)
    return torch.nn.functional.cross_entropy(logits, labels,
                                             reduction="sum")


def loss(params: dict, ref, dm, tokens, labels, quant=False,
         ce_rows: int = 2048):
    """Mean next-token cross-entropy of ``tokens`` [B, S] against
    ``labels`` [B, S]."""
    x = params["embed"][tokens].float()
    for w in ref.all_layers(params["blocks"]):
        x = checkpoint(ref.block, x, w, dm, quant, use_reentrant=False)
    h = x.reshape(-1, dm.d)
    lab = labels.reshape(-1)
    head = ref.head_weight(params, dm)
    total = 0.0
    for lo in range(0, h.shape[0], ce_rows):
        total = total + checkpoint(_ce_rows, h[lo:lo + ce_rows],
                                   lab[lo:lo + ce_rows],
                                   params["final_ln_w"], head, ref, dm,
                                   quant, use_reentrant=False)
    return total / h.shape[0]


def learning_rate(hp: dict, step: int) -> float:
    """The learning rate at (1-based) ``step``."""
    warm = min(step / max(hp["warmup_steps"], 1), 1.0)
    frac = min(max((step - hp["warmup_steps"])
                   / max(hp["total_steps"] - hp["warmup_steps"], 1), 0.0),
               1.0)
    return hp["learning_rate"] * warm * (
        0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * frac)))


def run(params: dict, ref, dm, batches: List[dict], hp: dict,
        store_dtype=torch.bfloat16, quant: bool = False) -> dict:
    """``len(batches)`` steps of the reference module ``ref`` (``dm``
    its ``Dims``) from ``params`` (stored in ``store_dtype``).
    Returns the losses, the first step's clipped gradient norm per leaf,
    its unclipped global norm, and each leaf's change after the last
    step (norms, float32)."""
    ref.no_tf32()
    start = {k: v.detach().to(store_dtype) for k, v in
             leaves(params).items()}
    stored = dict(start)
    m = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
         for k, v in stored.items()}
    v2 = {k: torch.zeros_like(t) for k, t in m.items()}
    b1, b2, eps = hp["beta1"], hp["beta2"], hp["eps"]
    out = {"losses": [], "grad": {}, "change": {}}
    for t, batch in enumerate(batches, start=1):
        p32 = {k: s.float().requires_grad_(True) for k, s in
               stored.items()}
        L = loss(unflatten(p32), ref, dm, batch["tokens"], batch["labels"],
                 quant)
        names = list(p32)
        grads = torch.autograd.grad(L, [p32[k] for k in names])
        g = dict(zip(names, grads))
        gnorm = torch.sqrt(sum((x * x).sum() for x in g.values()))
        scale = min(hp["grad_clip"] / max(float(gnorm), 1e-9), 1.0)
        lr = learning_rate(hp, t)
        with torch.no_grad():
            for k in names:
                gk = g[k] * scale
                if t == 1:
                    out["grad"][k] = float(gk.norm())
                m[k].mul_(b1).add_(gk, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
                step = ((m[k] / (1 - b1 ** t))
                        / (torch.sqrt(v2[k] / (1 - b2 ** t)) + eps)
                        + hp["weight_decay"] * p32[k])
                stored[k] = (p32[k] - lr * step).to(store_dtype)
        out["losses"].append(float(L.detach()))
        if t == 1:
            out["grad_global"] = float(gnorm)
        del p32, grads, g
    out["change"] = {k: float((stored[k].float() - start[k].float())
                              .norm()) for k in stored}
    return out
