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

`ssd_step` is the decode's one-token recurrence (the reference's
`ssd_step`, plain lax there and no kernel), with an fp32 state.

Beside them, the chunk-parallel form that the CUDA kernels compute, in plain
torch and with the chunks as a batch dimension:
  * `ssd_chunk_states`: each chunk's own state, then a short sequential
    pass that gives the state entering every chunk (phases 1-2 of the
    forward);
  * `ssd_chunk_dstates`: the same for the gradient, a reverse pass that
    gives the state gradient leaving every chunk;
  * `ssd_chunk_grads`: given both, every input's gradient, chunk by chunk
    in parallel, with B and C summed over the heads of a group;
  * `ssd_chunked_bwd`: the three composed, the explicit backward of
    `ssd_chunked` without a state;
  * `ssd_grad_terms`: the summed |terms| of each of its gradients, the
    scale of a tolerance for fp32 sums that cancel.
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


def ssd_step(S, x, dt, A, Bm, Cm, D=None):
    """One decode token: x (B,H,P); dt (B,H); Bm/Cm (B,G,N); S (B,H,P,N)
    fp32.  -> (S, y (B,H,P) in x's dtype)."""
    rep = x.shape[1] // Bm.shape[1]
    dtf = dt.float()
    dA = torch.exp(dtf * A[None, :])                       # (B,H)
    Bh = Bm.float().repeat_interleave(rep, dim=1)
    Ch = Cm.float().repeat_interleave(rep, dim=1)
    xf = x.float() * dtf[..., None]
    S = dA[..., None, None] * S + xf[..., :, None] * Bh[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", S, Ch)
    if D is not None:
        y = y + x * D[None, :, None]
    return S, y.to(x.dtype)


def _chunks(x, dt, A, Bm, Cm, chunk):
    """Zero-pads T to whole chunks: fp32 (B, nC, Lc, ...) tensors x, dt, and
    B and C repeated over the heads (B, nC, Lc, H, N), and cum, the inclusive
    cumsum of dt*A over each chunk (B, nC, Lc, H)."""
    Bsz, T, H, _ = x.shape
    Lc = min(chunk, T)
    pad = (-T) % Lc

    def rs(a):
        a = F.pad(a.float(), (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape(Bsz, -1, Lc, *a.shape[2:])

    rep = H // Bm.shape[2]
    xc, dtc = rs(x), rs(dt)
    Bh = rs(Bm).repeat_interleave(rep, dim=3)
    Ch = rs(Cm).repeat_interleave(rep, dim=3)
    return xc, dtc, Bh, Ch, torch.cumsum(dtc * A.float(), dim=2)


def _unchunk(a, T):
    """(B, nC, Lc, ...) -> (B, T, ...)."""
    return a.reshape(a.shape[0], -1, *a.shape[3:])[:, :T]


def _scan(loc, decay, reverse=False):
    """The sequential pass over the chunks: out[c] is the sum carried into
    chunk c (from the first chunk on, or from the last one back), run(c+1)
    = decay[c] run(c) + loc[c].  loc (B,H,nC,P,N), decay (B,nC,H).
    -> (out, the sum carried out of the last chunk)."""
    out = torch.empty_like(loc)
    run = torch.zeros_like(loc[:, :, 0])
    order = range(loc.shape[2])
    for c in reversed(order) if reverse else order:
        out[:, :, c] = run
        run = decay[:, c, :, None, None] * run + loc[:, :, c]
    return out, run


def ssd_chunk_states(x, dt, A, Bm, Cm, chunk: int = 128):
    """Phases 1-2 of the chunk-parallel forward, without a state.
    -> (S_in (B,H,nC,P,N): the state entering each chunk, S (B,H,P,N): the
    final state), fp32.  Chunk c's own state is sum_s exp(cum_last - cum_s)
    dt_s x_s B_s^T; the pass carries S_in[c+1] = exp(cum_last[c]) S_in[c] +
    that."""
    xc, dtc, Bh, _, cum = _chunks(x, dt, A, Bm, Cm, chunk)
    w = torch.exp(cum[:, :, -1:] - cum) * dtc               # (B,nC,Lc,H)
    loc = torch.einsum("bcsh,bcshp,bcshn->bhcpn", w, xc, Bh)
    return _scan(loc, torch.exp(cum[:, :, -1]))


def ssd_chunk_dstates(dy, dt, A, Cm, chunk: int = 128):
    """The reverse pass of the backward: dS_out (B,H,nC,P,N) fp32, the
    gradient of the state leaving each chunk (0 for the last).  Chunk c's
    own part is sum_t exp(cum_t) dy_t C_t^T; the pass carries dS_out[c-1] =
    exp(cum_last[c]) dS_out[c] + that."""
    _, _, _, Ch, cum = _chunks(dy, dt, A, Cm, Cm, chunk)
    Bsz, nC, Lc = cum.shape[:3]
    dyc = F.pad(dy.float(), (0, 0, 0, 0, 0, nC * Lc - dy.shape[1])).reshape(
        Bsz, nC, Lc, *dy.shape[2:])
    loc = torch.einsum("bcth,bcthp,bcthn->bhcpn", torch.exp(cum), dyc, Ch)
    return _scan(loc, torch.exp(cum[:, :, -1]), reverse=True)[0]


def ssd_chunk_grads(x, dt, A, Bm, Cm, D, dy, states, dstates,
                    chunk: int = 128):
    """Every input's gradient, each chunk on its own given the state
    entering it (`states`, from `ssd_chunk_states`) and the gradient of the
    state leaving it (`dstates`, from `ssd_chunk_dstates`).
    -> (dx, ddt, dA, dB, dC, dD) in the inputs' dtypes (dD None without D).

    With L[t,s] = exp(cum_t - cum_s) on s <= t (masked before exp), M = C
    B^T o L and xd = dt x: y = M xd + exp(cum) C S_in^T + D x, and the
    state leaving is exp(cum_last) S_in + sum_s exp(cum_last - cum_s) xd_s
    B_s^T.  dcum collects every exponent's gradient; da = dt*A takes its
    reverse cumsum within the chunk."""
    return _chunk_grads(x, dt, A, Bm, Cm, D, dy, states, dstates, chunk)


def _chunk_grads(x, dt, A, Bm, Cm, D, dy, states, dstates, chunk,
                 terms=False, one_part=False):
    """`ssd_chunk_grads`; `terms`: every subtraction made an addition and
    A taken as |A| in ddt, fp32 results (see `ssd_grad_terms`); `one_part`:
    M and dM o L rounded to one bf16 part where they enter a product (dx,
    dB, dC), a planted fault for the card's checks (the kernels keep them
    as bf16 hi + lo)."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    sign = 1.0 if terms else -1.0
    xc, dtc, Bh, Ch, cum = _chunks(x, dt, A, Bm, Cm, chunk)
    nC, Lc = xc.shape[1], xc.shape[2]
    dyc = F.pad(dy.float(), (0, 0, 0, 0, 0, nC * Lc - T)).reshape(xc.shape)
    S_in = states.transpose(1, 2)                        # (B,nC,H,P,N)
    dS_out = dstates.transpose(1, 2)
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    Ldec = torch.exp(torch.where(tri[:, :, None],
                                 cum[:, :, :, None] - cum[:, :, None],
                                 float("-inf")))         # (B,nC,t,s,H)
    ecum = torch.exp(cum)
    w = torch.exp(cum[:, :, -1:] - cum)
    xd = xc * dtc[..., None]
    M = torch.einsum("bcthn,bcshn->bctsh", Ch, Bh) * Ldec
    dM = torch.einsum("bcthp,bcshp->bctsh", dyc, xd)
    dCB = dM * Ldec
    Mp, dCBp = (M.bfloat16().float(), dCB.bfloat16().float()) if one_part \
        else (M, dCB)
    # through the state leaving the chunk: H_s = dS_out B_s
    Hs = torch.einsum("bchpn,bcshn->bcshp", dS_out, Bh)
    dxd = torch.einsum("bctsh,bcthp->bcshp", Mp, dyc) + w[..., None] * Hs
    dCh = torch.einsum("bctsh,bcshn->bcthn", dCBp, Bh) + ecum[..., None] \
        * torch.einsum("bcthp,bchpn->bcthn", dyc, S_in)
    dBh = torch.einsum("bctsh,bcthn->bcshn", dCBp, Ch) + (w * dtc)[..., None] \
        * torch.einsum("bcshp,bchpn->bcshn", xc, dS_out)
    Q = dM * M
    y_inter = ecum[..., None] * torch.einsum("bcthn,bchpn->bcthp", Ch, S_in)
    r = w * (xd * Hs).sum(-1)
    dcum = Q.sum(3) + sign * Q.sum(2) + (dyc * y_inter).sum(-1) + sign * r
    dcum[:, :, -1] += r.sum(2) + torch.exp(cum[:, :, -1]) * (
        S_in * dS_out).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    a = A.float().abs() if terms else A.float()
    ddt = _unchunk(a * da + (xc * dxd).sum(-1), T)
    dx = _unchunk(dtc[..., None] * dxd, T)
    dA = (dtc * da).sum((0, 1, 2))
    dD = None
    if D is not None:
        dx = dx + dy.float() * D.float()[None, None, :, None]
        dD = (dy.float() * x.float()).sum((0, 1, 3))

    def per_group(d):
        return _unchunk(d, T).reshape(Bsz, T, G, H // G, N).sum(3)

    out = (dx, ddt, dA, per_group(dBh), per_group(dCh), dD)
    if terms:
        return out
    return tuple(None if g is None else g.to(t.dtype)
                 for g, t in zip(out, (x, dt, A, Bm, Cm, D)))


def ssd_grad_terms(x, dt, A, Bm, Cm, D, dy, chunk: int = 128):
    """The sum of the absolute values of the terms that make up each element
    of `ssd_chunked_bwd`'s gradients, fp32: the same backward on |x|, |B|,
    |C|, |D| and |dy| with every subtraction made an addition.  A tolerance
    for a long fp32 sum that cancels scales with these (two summation
    orders differ by the rounding of the terms, not of the result)."""
    ax, aB, aC, ady = x.abs(), Bm.abs(), Cm.abs(), dy.abs()
    states, _ = ssd_chunk_states(ax, dt, A, aB, aC, chunk)
    dstates = ssd_chunk_dstates(ady, dt, A, aC, chunk)
    return _chunk_grads(ax, dt, A, aB, aC, None if D is None else D.abs(),
                        ady, states, dstates, chunk, terms=True)


def ssd_chunked_bwd(x, dt, A, Bm, Cm, D, dy, chunk: int = 128):
    """The explicit backward of `ssd_chunked` without a state: the forward
    states, the reverse pass, then every chunk in parallel.
    -> (dx, ddt, dA, dB, dC, dD) as `ssd_chunk_grads`."""
    states, _ = ssd_chunk_states(x, dt, A, Bm, Cm, chunk)
    dstates = ssd_chunk_dstates(dy, dt, A, Cm, chunk)
    return ssd_chunk_grads(x, dt, A, Bm, Cm, D, dy, states, dstates, chunk)
