"""Plain PyTorch Mamba2 SSD chunked scan: a line-for-line mirror of the
jnp branch of the JAX package's ``models/ssm.py::ssd_chunked`` (its
oracle ``kernels/ssd_scan/ref.py``): the same padding of S to the chunk,
cumsum, tril mask, ``exp(seg)`` under the mask and sequential
inter-chunk recurrence, all in fp32.  The mask is applied to the
exponent (the same values), so that the gradient, which the train mode
takes through this version, stays finite at full-size chunks.  The
recurrence declares itself to ``utils/step_analyzer.py`` (JAX's
``lax.scan`` over chunks is a loop of the compiled program)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils.step_analyzer import note_loop


def ssd_scan_ref(xb, a, B_mat, C_mat, *, chunk, initial_state=None):
    """xb: [B,S,H,P]; a: [B,S,H]; B/C: [B,S,G,N] (grouped, like the
    model); initial_state: [B,H,P,N] or None.  Returns (y [B,S,H,P] in
    xb's dtype, final_state [B,H,P,N] fp32)."""
    B, S, H, P = xb.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    assert H % G == 0
    pad = (-S) % chunk
    if pad:
        xb = F.pad(xb, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, 0, 0, pad))
    Sp = S + pad
    nc, Q = Sp // chunk, chunk
    xb_c = xb.reshape(B, nc, Q, H, P)
    a_c = a.reshape(B, nc, Q, H).float()
    B_c = B_mat.reshape(B, nc, Q, G, N)
    C_c = C_mat.reshape(B, nc, Q, G, N)

    cum = torch.cumsum(a_c, dim=2)                      # [B,nc,Q,H]
    # broadcast groups to heads for the CB inner products
    rep = H // G
    Bh = torch.repeat_interleave(B_c, rep, dim=3).float()   # [B,nc,Q,H,N]
    Ch = torch.repeat_interleave(C_c, rep, dim=3).float()

    # ---- intra-chunk (the "attention-like" quadratic-in-Q term)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,i,j,H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xb.device))
    # the exponent is masked before exp, not the exp after it: the same
    # values (exp(-inf) = 0), but above the diagonal seg is a sum of decays
    # (> 0) that overflows to inf at full-size chunks, and the gradient of
    # where(tri, exp(seg), 0) there is 0 * inf = NaN (the JAX package's
    # jnp branch has it; ROADMAP.md, Queue 3)
    L = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                              float("-inf")))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    M = cb * L                                          # [B,nc,i,j,H]
    xf = xb_c.float()
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xf)

    # ---- per-chunk terminal states
    a_last = cum[:, :, -1, :]                           # [B,nc,H]
    decay_out = torch.exp(a_last[:, :, None, :] - cum)  # [B,nc,Q,H]
    states = torch.einsum("bcjh,bcjhn,bcjhp->bchpn", decay_out, Bh, xf)

    # ---- inter-chunk recurrence
    s = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xb.device)
         if initial_state is None else initial_state.float())
    prev = []
    note_loop("ssd_chunks", nc)
    for c in range(nc):
        prev.append(s)
        s = s * torch.exp(a_last[:, c])[:, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                  # [B,nc,H,P,N]

    y_inter = torch.einsum("bcihn,bchpn->bcihp",
                           Ch * torch.exp(cum)[..., None], prev_states)
    y = (y_intra + y_inter).reshape(B, Sp, H, P)[:, :S]
    return y.to(xb.dtype), s
