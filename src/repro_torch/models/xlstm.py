"""xLSTM family (port of `repro.models.xlstm`): only `causal_conv1d` so far,
which zamba2's Mamba layers import from here as the reference's do.  The
xLSTM model itself is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(x, w, state=None):
    """x: (B,T,C); w: (K,C) depthwise causal conv. state: (B,K-1,C).

    A sum of K shifted products, as the reference writes it (not
    `F.conv1d`, which runs through cuDNN in TF32 on the card by default).
    Returns (out (B,T,C), new_state (B,K-1,C) or None when K == 1)."""
    K, T = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i:i + T] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return out, new_state
