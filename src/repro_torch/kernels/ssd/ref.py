"""Plain PyTorch Mamba-2 SSD (state-space dual) chunk scan: the CPU path of
`ops.ssd`, the function its backward differentiates, and the oracle the
CUDA kernel is held against on the card.  Port of
`repro/kernels/ssd/ref.py` `ssd_chunked`, with a Python loop over the
chunks in place of `lax.scan`.

Shapes: x (B,T,H,P) [P = head dim], dt (B,T,H) positive, A (H,) negative,
Bm/Cm (B,T,G,N) [N = d_state, G groups, H % G == 0], D (H,) skip.  The
internals are fp32; y comes back in x's dtype.

One departure, in the gradient only: the decay matrix is exp(cum_t -
cum_s) on the lower triangle.  The reference takes exp of the whole
square and masks afterwards, so where the decay across a chunk exceeds
~88 the masked upper triangle overflows to inf and its VJP (0 * inf) makes
the dt and A gradients NaN.  Here the exponent is masked to -inf before
exp: the same values, and a gradient equal to the reference's wherever
that one is finite.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunked(x, dt, A, Bm, Cm, D=None, chunk: int = 128, state=None):
    """-> (y (B,T,H,P) in x's dtype, final state S (B,H,P,N) fp32)."""
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Lc = min(chunk, T)
    pad = (-T) % Lc
    if pad:
        x_p = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    else:
        x_p = x
    nC = (T + pad) // Lc
    S = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) \
        if state is None else state
    A32 = A.float()
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nC):
        sl = slice(c * Lc, (c + 1) * Lc)
        dtf = dt[:, sl].float()
        cum = torch.cumsum(dtf * A32[None, None, :], dim=1)  # (B,Lc,H)
        # L[t,s] = exp(cum_t - cum_s) for s <= t (decay between s and t)
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        Ldec = torch.exp(torch.where(tri[None, :, :, None], diff,
                                     float("-inf")))
        xf = x_p[:, sl].float() * dtf[..., None]          # dt-weighted
        Bh = Bm[:, sl].float().repeat_interleave(rep, dim=2)  # (B,Lc,H,N)
        Ch = Cm[:, sl].float().repeat_interleave(rep, dim=2)
        # intra-chunk: y_t = sum_s<=t (C_t . B_s) L[t,s] x_s
        CB = torch.einsum("blhn,bshn->blsh", Ch, Bh)
        y_intra = torch.einsum("blsh,bshp->blhp", CB * Ldec, xf)
        # inter-chunk: y_t += C_t . (decay_t * S_in)
        y_inter = torch.einsum("blhn,bhpn->blhp", Ch, S) \
            * torch.exp(cum)[..., None]
        ys.append(y_intra + y_inter)
        # state: S_out = exp(cum_T) S_in + sum_s exp(cum_T - cum_s) B_s x_s
        decT = torch.exp(cum[:, -1])                       # (B,H)
        w = torch.exp(cum[:, -1][:, None] - cum)           # (B,Lc,H)
        S = decT[..., None, None] * S + torch.einsum(
            "bshp,bshn->bhpn", xf * w[..., None], Bh)
    y = torch.cat(ys, dim=1)[:, :T]
    if D is not None:
        y = y + x * D[None, None, :, None]
    return y.to(x.dtype), S
