"""xLSTM family (xlstm-1.3b), training and serving (port of
`repro.models.xlstm`): superblocks of 7 mLSTM blocks and 1 sLSTM block
(arXiv:2405.04517).

mLSTM: a matrix-memory cell with stabilized exponential gating, in the
chunkwise parallel form (`mlstm_chunked`: the quadratic form inside a chunk,
the (C, n, m) state carried across chunks) for training and prefill, and
the one-token recurrence (`mlstm_step`) for decode.  sLSTM: a scalar-memory
cell with per-head recurrent mixing R, strictly sequential over time
(`slstm_seq`).  Both cells are plain PyTorch: the reference runs them in
lax (a scan over chunks, a scan over time) and has no kernel for them.
`slstm_seq` is a Python loop over the time steps: each step issues its own
small device ops, so at full width its cost is the host's.

Every computation follows the reference's dtypes: the cells run in fp32
whatever the compute dtype (q, k, v and the gate pre-activations are cast,
R is widened to fp32 as JAX promotes a bf16 x fp32 product), the
projections run in the compute dtype.  Ties resolve as in JAX: `amax`
splits a gradient evenly among tied maxima, as does `torch.maximum`
between its two arguments.

Training: the 6 superblocks run through `core/stack.apply_stack` (so
bucketing, remat and the prefetch stack apply), each sub-block under its
own `torch.utils.checkpoint`, as the reference wraps each in
`jax.checkpoint`: the backward re-derives one cell's internals at a time.
The norms go through the rmsnorm kernel, the loss through the logits and
cross-entropy kernels, as in the dense family.

Serving keeps O(1) state a sub-block: `init_state` lays it out as the
reference's `cache_abstract` does (each mLSTM's C, n, m and conv state, each
sLSTM's h, c, n, m; fp32, stacked over the superblocks); `prefill_local`
runs the prompt through `mlstm_chunked` / `slstm_seq` and fills it,
`decode_local` advances it one token a row; both update the cache in
place.  A ragged last chunk is padded with f_pre = 30 and i_pre = 0: the
pads can raise the final stabilizer m, while C e^m, n e^m and every output
stay those of the true tokens.

Simplifications of the reference kept (its docstring): full-matrix q/k/v
projections instead of block-diagonal-4, no learnable skip scales.  Not
ported, each raising "not yet ported": the pipeline-stage contract
(`stage_spec`, pp > 1) and tp > 1.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import collectives as coll
from repro_torch.core.dist import DistConfig
from repro_torch.core.irgraph import BlockStats
from repro_torch.core.meta import ParamMeta, named_leaves, tree_map
from repro_torch.core.remat import maybe_remat
from repro_torch.core.stack import apply_stack
from repro_torch.models import layers as LY
from repro_torch.models.common import ArchConfig, InputSpec, ShapeConfig

M0 = -1e30          # the empty state's stabilizer (not -inf: exp(-inf + inf))
MLSTM_STATE = ("C", "n", "m", "conv")
SLSTM_STATE = ("h", "c", "n", "m")


def _logsig(x):
    """log(sigmoid(x)), exact on both tails (the reference's
    -softplus(-x))."""
    return F.logsigmoid(x)


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise parallel form (training / prefill)
# ---------------------------------------------------------------------------
def mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int = 64, state=None):
    """q, k: (B,T,H,dk); v: (B,T,H,dv); i_pre, f_pre: (B,T,H)
    pre-activations; state: an incoming (C (B,H,dk,dv), n (B,H,dk), m
    (B,H)) fp32, or None for the empty state.  Returns y (B,T,H,dv) in v's
    dtype and the final state (C, n, m)."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    Lc = min(chunk, T)
    pad = (-T) % Lc
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        i_pre = F.pad(i_pre, (0, 0, 0, pad))
        f_pre = F.pad(f_pre, (0, 0, 0, pad), value=30.0)  # decay ~1 on pads
    nC = (T + pad) // Lc
    scale = dk ** -0.5
    dev = q.device
    if state is None:
        C = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=dev)
        n = torch.zeros((B, H, dk), dtype=torch.float32, device=dev)
        m = torch.full((B, H), M0, dtype=torch.float32, device=dev)
    else:
        C, n, m = state
    floor = torch.full((), M0, dtype=torch.float32, device=dev)
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=dev).tril()
    off = ~tri[None, :, :, None]
    # one split per input: its backward joins the chunks' gradients once,
    # where slicing a chunk at a time would add a full-length zero
    # gradient a chunk
    qs, ks, vs, is_, fs = (a.split(Lc, dim=1)
                           for a in (q, k, v, i_pre, f_pre))
    ys = []
    for c in range(nC):
        lf = _logsig(fs[c].float())                         # (B,Lc,H)
        li = is_[c].float()
        Fc = torch.cumsum(lf, dim=1)                        # inclusive
        Ftot = Fc[:, -1]                                    # (B,H)
        # D[t, s] = F_t - F_s + li_s  (s <= t)
        D = Fc[:, :, None] - Fc[:, None, :, :] + li[:, None, :, :]
        D = D.masked_fill(off, float("-inf"))
        m_local = D.amax(dim=2)                             # (B,Lc,H)
        m_cross = Fc + m[:, None]
        m_t = torch.maximum(torch.maximum(m_local, m_cross), floor)
        # intra-chunk
        qf = qs[c].float() * scale
        kf = ks[c].float()
        vf = vs[c].float()
        S = torch.einsum("blhd,bshd->blsh", qf, kf)
        W = torch.exp(D - m_t[:, :, None]).masked_fill(off, 0.0)
        y_intra = torch.einsum("blsh,bshv->blhv", S * W, vf)
        n_intra = torch.einsum("blsh,bshd->blhd", W, kf)
        # inter-chunk (the incoming state)
        g_cross = torch.exp(m_cross - m_t)                  # (B,Lc,H)
        y_inter = torch.einsum("blhd,bhdv->blhv", qf, C) \
            * g_cross[..., None]
        n_t = n_intra + n[:, None] * g_cross[..., None]
        denom = torch.maximum(
            torch.einsum("blhd,blhd->blh", qf, n_t).abs(), torch.exp(-m_t))
        ys.append((y_intra + y_inter) / denom[..., None])
        # outgoing state
        g_out = Ftot[:, None] - Fc + li                     # decay to end
        m_out = torch.maximum(Ftot + m, g_out.amax(dim=1))
        kw = kf * torch.exp(g_out - m_out[:, None])[..., None]
        decay = torch.exp(Ftot + m - m_out)
        C = decay[..., None, None] * C \
            + torch.einsum("bshd,bshv->bhdv", kw, vf)
        n = decay[..., None] * n + kw.sum(dim=1)
        m = m_out
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(v.dtype), (C, n, m)


def mlstm_step(state, q, k, v, i_pre, f_pre):
    """Recurrent decode step. state: (C, n, m) fp32; q, k: (B,H,dk); v:
    (B,H,dv); gates (B,H).  Returns (the new state, y (B,H,dv) in v's
    dtype)."""
    C, n, m = state
    scale = q.shape[-1] ** -0.5
    lf = _logsig(f_pre.float())
    li = i_pre.float()
    m_new = torch.maximum(lf + m, li)
    fg = torch.exp(lf + m - m_new)
    ig = torch.exp(li - m_new)
    kf = k.float()
    vf = v.float()
    C = fg[..., None, None] * C \
        + ig[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n = fg[..., None] * n + ig[..., None] * kf
    qf = q.float() * scale
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(),
                          torch.exp(-m_new))
    y = torch.einsum("bhd,bhdv->bhv", qf, C) / denom[..., None]
    return (C, n, m_new), y.to(v.dtype)


# ---------------------------------------------------------------------------
# sLSTM cell (sequential over time)
# ---------------------------------------------------------------------------
def slstm_seq(xg, R, state=None):
    """xg: (B,T,4,H,hd) gate pre-activations [i, f, z, o]; R: (4,H,hd,hd);
    state: (h, c, n, m), each (B,H,hd) fp32, or None for the empty state.
    Returns (hs (B,T,H,hd) fp32, the final state).

    One time step a loop iteration, as the reference's scan: the four
    gates' recurrent products in one batched product a head, R widened to
    fp32."""
    B, T, _, H, hd = xg.shape
    dev = xg.device
    if state is None:
        z = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
        state = (z, z, torch.ones_like(z), z)
    # head-major: (H, B, hd) states, (H, hd, 4 hd) recurrent weights and
    # T inputs of (H, B, 4 hd), so a step is one baddbmm; one unbind, whose
    # backward stacks the T steps' gradients once (indexing a step at a
    # time would add a full-length zero gradient a step)
    h, c, n, m = (a.transpose(0, 1) for a in state)
    Rh = R.float().permute(1, 2, 0, 3).reshape(H, hd, 4 * hd)
    xs = xg.float().permute(1, 3, 0, 2, 4).reshape(T, H, B, 4 * hd) \
        .unbind(0)
    hs = []
    for t in range(T):
        it, ft, zt, ot = torch.baddbmm(xs[t], h, Rh).view(
            H, B, 4, hd).unbind(2)
        lfm = _logsig(ft) + m
        m_new = torch.maximum(lfm, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(lfm - m_new)
        c = f_ * c + i_ * torch.tanh(zt)
        n = f_ * n + i_
        h = torch.sigmoid(ot) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    hs = torch.stack(hs, dim=2).permute(1, 2, 0, 3)         # (B,T,H,hd)
    return hs, tuple(a.transpose(0, 1) for a in (h, c, n, m))


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


def _unported(what: str):
    raise NotImplementedError(
        f"xlstm {what} is not yet ported to repro_torch (training and "
        "serving at pp=1, tp=1 are)")


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
class XLSTMLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.family != "xlstm":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not xlstm")
        self.cfg = cfg
        self.per = cfg.slstm_every or 8          # 7 mLSTM + 1 sLSTM
        if cfg.n_layers % self.per:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                             f"whole superblocks of {self.per}")
        self.n_steps = cfg.n_layers // self.per
        self.d_inner = cfg.ssm_expand * cfg.d_model
        self.n_heads = cfg.n_heads
        self.dk = self.d_inner // cfg.n_heads

    # ------------------------------------------------------------- metas --
    def _mlstm_metas(self, dt, tag) -> dict:
        d, di, H, dk = self.cfg.d_model, self.d_inner, self.n_heads, self.dk
        K = self.cfg.ssm_conv
        # the value path shards the per-head value dim (tp_dim on the
        # head-split layout), as in the reference
        return {
            "ln": LY.norm_meta(tag + "ln", d, dt),
            "w_x": ParamMeta(tag + "w_x", (d, di), None, dt),
            "w_z": ParamMeta(tag + "w_z", (d, H, dk), 2, dt),
            "conv": ParamMeta(tag + "conv", (K, di), None, dt),
            "wq": ParamMeta(tag + "wq", (di, di), None, dt),
            "wk": ParamMeta(tag + "wk", (di, di), None, dt),
            "wv": ParamMeta(tag + "wv", (di, H, dk), 2, dt),
            "w_if": ParamMeta(tag + "w_if", (di, 2 * H), None, dt),
            "w_out": ParamMeta(tag + "w_out", (H, dk, d), 1, dt),
        }

    def _slstm_metas(self, dt, tag) -> dict:
        d, H = self.cfg.d_model, self.n_heads
        hd = d // H
        return {
            "ln": LY.norm_meta(tag + "ln", d, dt),
            "w_g": ParamMeta(tag + "w_g", (d, 4 * d), None, dt),
            "R": ParamMeta(tag + "R", (4, H, hd, hd), None, dt),
            "w_out": ParamMeta(tag + "w_out", (d, d), None, dt),
        }

    def block_metas(self, dcfg: DistConfig) -> dict:
        dt = dcfg.storage_dtype
        m = {f"m{i}": self._mlstm_metas(dt, f"m{i}.")
             for i in range(self.per - 1)}
        m["s"] = self._slstm_metas(dt, "s.")
        return m

    def metas(self, dcfg: DistConfig) -> dict:
        dt = dcfg.storage_dtype
        return {
            "embed": LY.embed_meta("embed", self.cfg, dt),
            "blocks": self.block_metas(dcfg),     # stacked over n_steps
            "final_norm": LY.norm_meta("final_norm", self.cfg.d_model, dt),
            "head": LY.head_meta("head", self.cfg, dt),
        }

    @property
    def stacked_keys(self) -> dict:
        return {"blocks": self.n_steps}

    def n_params(self) -> int:
        """Sum of the metas' global sizes (the blocks once per
        superblock)."""
        from repro_torch.models.runtime import n_params
        return n_params(self)

    def input_specs(self, shape: ShapeConfig, dcfg: DistConfig) -> dict:
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            return {"tokens": InputSpec((B, S), "int32"),
                    "targets": InputSpec((B, S), "int32"),
                    "valid": InputSpec((B, S), "float32")}
        if shape.kind == "prefill":
            return {"tokens": InputSpec((B, S), "int32")}
        return {"tok": InputSpec((B,), "int32")}

    def stage_spec(self, n_stages: int):
        _unported("stage_spec (pipeline stages)")

    def block_stats(self, dcfg: DistConfig, batch_shape) -> BlockStats:
        """Per-superblock workload for auto-wrapping, per device: the
        reference's (2 x tokens x numel FLOPs a leaf)."""
        B, S = batch_shape          # per-device microbatch
        tokens = B * S
        it = dcfg.param_dtype.itemsize
        pf, pb = {}, {}
        for nm, m in named_leaves(self.block_metas(dcfg)):
            numel = m.numel_local(dcfg)
            pf[nm] = 2.0 * tokens * numel
            pb[nm] = numel * it
        return BlockStats(param_flops=pf, param_bytes=pb,
                          act_bytes=tokens * self.cfg.d_model * it
                          / dcfg.tp_size)

    def bucket_units(self) -> list[list[str]]:
        """Manual-wrapping module lists: one a sub-block."""
        return [[f"m{i}/*"] for i in range(self.per - 1)] + [["s/*"]]

    def consts(self, seq_len: int, device) -> dict:
        return {}

    # -------------------------------------------------------------- init --
    def _mlstm_init(self, generator, device, dtype) -> dict:
        """One mLSTM block with the reference's distributions."""
        cfg = self.cfg
        d, di, H, dk = cfg.d_model, self.d_inner, self.n_heads, self.dk
        K = cfg.ssm_conv
        sd = 0.02

        def normal(shape, std):
            return LY._normal(shape, std, generator, device, dtype)

        return {
            "ln": LY.norm_init(d, device, dtype),
            "w_x": normal((d, di), sd),
            "w_z": normal((d, H, dk), sd),
            "conv": normal((K, di), 1.0 / math.sqrt(K)),
            "wq": normal((di, di), sd),
            "wk": normal((di, di), sd),
            "wv": normal((di, H, dk), sd),
            "w_if": normal((di, 2 * H), 0.005),
            "w_out": normal((H, dk, d), sd / math.sqrt(2 * cfg.n_layers)),
        }

    def _slstm_init(self, generator, device, dtype) -> dict:
        cfg = self.cfg
        d, H = cfg.d_model, self.n_heads
        hd = d // H

        def normal(shape, std):
            return LY._normal(shape, std, generator, device, dtype)

        return {
            "ln": LY.norm_init(d, device, dtype),
            "w_g": normal((d, 4 * d), 0.02),
            "R": normal((4, H, hd, hd), 1.0 / math.sqrt(hd)),
            "w_out": normal((d, d), 0.02 / math.sqrt(2 * cfg.n_layers)),
        }

    def init_full(self, generator: torch.Generator, dcfg: DistConfig,
                  device, dtype: torch.dtype) -> dict:
        """Full params with the reference's distributions, made on `device`
        in `dtype` one sub-block at a time."""
        cfg = self.cfg
        blocks = tree_map(
            lambda m: torch.empty((self.n_steps, *m.global_shape),
                                  device=device, dtype=dtype),
            self.block_metas(dcfg))
        for i in range(self.n_steps):
            for j in range(self.per - 1):
                tree_map(lambda dst, src: dst[i].copy_(src), blocks[f"m{j}"],
                         self._mlstm_init(generator, device, dtype))
            tree_map(lambda dst, src: dst[i].copy_(src), blocks["s"],
                     self._slstm_init(generator, device, dtype))
        return {
            "embed": LY.embed_init(generator, cfg, device, dtype),
            "blocks": blocks,
            "final_norm": LY.norm_init(cfg.d_model, device, dtype),
            "head": LY.head_init(generator, cfg, device, dtype),
        }

    # ------------------------------------------------------------- apply --
    def _mlstm(self, p, x, st=None):
        """One mLSTM block over x (B,T,d), from the layer's serving state
        `st` (C, n, m, conv; None: the empty state).  Returns (x + the
        block's output, the state after x)."""
        cfg = self.cfg
        B, T, d = x.shape
        H, dk = self.n_heads, self.dk
        h = LY.rmsnorm(x, p["ln"], cfg.norm_eps)
        x_in = torch.matmul(h, p["w_x"])
        conv_in = None if st is None else st["conv"].to(x_in.dtype)
        xc, conv = causal_conv1d(x_in, p["conv"], state=conv_in)
        xc = F.silu(xc)
        q = torch.matmul(xc, p["wq"]).view(B, T, H, dk)
        k = torch.matmul(xc, p["wk"]).view(B, T, H, dk)
        v = torch.matmul(x_in, p["wv"].reshape(-1, H * dk)).view(B, T, H, dk)
        gates = torch.matmul(xc, p["w_if"])
        i_pre, f_pre = gates[..., :H], gates[..., H:] + 3.0  # forget bias
        z = torch.matmul(h, p["w_z"].reshape(d, H * dk)).view(B, T, H, dk)
        if T == 1 and st is not None:
            (C, n, m), y = mlstm_step((st["C"], st["n"], st["m"]), q[:, 0],
                                      k[:, 0], v[:, 0], i_pre[:, 0],
                                      f_pre[:, 0])
            y = y[:, None]
        else:
            y, (C, n, m) = mlstm_chunked(
                q, k, v, i_pre, f_pre, chunk=cfg.ssm_chunk,
                state=None if st is None else (st["C"], st["n"], st["m"]))
        y = y * F.silu(z)
        o = torch.matmul(y.reshape(B, T, H * dk),
                         p["w_out"].reshape(H * dk, d))
        return x + o, {"C": C, "n": n, "m": m, "conv": conv.float()}

    def _slstm(self, p, x, st=None):
        """One sLSTM block over x (B,T,d) from the state `st` (h, c, n, m;
        None: the empty state).  Returns (x + output, the state after
        x)."""
        cfg = self.cfg
        B, T, d = x.shape
        H = self.n_heads
        h = LY.rmsnorm(x, p["ln"], cfg.norm_eps)
        g = torch.matmul(h, p["w_g"]).view(B, T, 4, H, d // H)
        hs, state = slstm_seq(g, p["R"], None if st is None
                              else tuple(st[k] for k in SLSTM_STATE))
        o = torch.matmul(hs.reshape(B, T, d).to(x.dtype), p["w_out"])
        return x + o, dict(zip(SLSTM_STATE, state))

    def _mlstm_block(self, p, x):
        return self._mlstm(p, x)[0]

    def _slstm_block(self, p, x):
        return self._slstm(p, x)[0]

    def block_fn(self, p, consts, x, dcfg: DistConfig):
        """One superblock; each sub-block under its own checkpoint, so a
        backward re-derives one cell's internals at a time."""
        for i in range(self.per - 1):
            x = checkpoint(self._mlstm_block, p[f"m{i}"], x,
                           use_reentrant=False)
        x = checkpoint(self._slstm_block, p["s"], x, use_reentrant=False)
        return x, {}

    # ------------------------------------------------------------- train --
    def stage_pre(self, storage, mb, dcfg: DistConfig):
        cfg = self.cfg
        emb_meta = LY.embed_meta("embed", cfg, dcfg.storage_dtype)

        def embed_fn(shard, ids):
            table = coll.replicate(shard, emb_meta, dcfg)
            return LY.embed_apply(table, ids, cfg, dcfg)

        return maybe_remat(embed_fn, "fsdp_only")(storage["embed"],
                                                  mb["tokens"]), {}

    def stage_blocks(self, storage, state, dcfg: DistConfig, plan=None):
        """The superblock stack under the SimpleFSDP schedule (core/stack)
        with the blocks' bucket `plan`; without one the stack resolves it
        from this rank's (B, S) workload."""
        x, aux = state
        blk = functools.partial(self.block_fn, dcfg=dcfg)
        x, aux2 = apply_stack(blk, self.block_metas(dcfg), dcfg,
                              storage["blocks"], self.consts(0, x.device), x,
                              plan=plan, block_stats=self.block_stats(
                                  dcfg, tuple(x.shape[:2])))
        return x, {k: aux.get(k, 0) + v for k, v in aux2.items()}

    def stage_loss(self, storage, state, mb, dcfg: DistConfig):
        cfg = self.cfg
        x, _ = state
        fn_meta = LY.norm_meta("final_norm", cfg.d_model, dcfg.storage_dtype)
        w_fn = coll.replicate(storage["final_norm"], fn_meta, dcfg)
        x = LY.rmsnorm(x, w_fn, cfg.norm_eps)
        hd_meta = LY.head_meta("head", cfg, dcfg.storage_dtype)
        w = coll.replicate(storage["head"], hd_meta, dcfg)
        loss, _ = LY.vocab_parallel_xent(LY.logits_f32(x, w, cfg),
                                         mb["targets"], mb["valid"])
        return loss

    def loss_local(self, storage, batch, dcfg: DistConfig, plan=None):
        """batch: tokens/targets (B, S) int, valid (B, S) fp32.  Returns
        (this rank's masked mean loss, aux).  `plan`: the blocks' bucket
        plan (`stage_blocks`)."""
        state = self.stage_blocks(storage,
                                  self.stage_pre(storage, batch, dcfg), dcfg,
                                  plan)
        return self.stage_loss(storage, state, batch, dcfg), state[1]

    # ------------------------------------------------------------- serve --
    def init_state(self, batch_local: int, dcfg: DistConfig,
                   seq_len: int = 0) -> dict:
        """The serving state's leaves on the meta device (shapes and dtypes;
        `train.serve.alloc_cache` makes them), laid out as the reference's
        `cache_abstract` at tp = 1, every leaf fp32 and stacked over the
        n_steps superblocks: per mLSTM sub-block m<i> C (L, B, H, dk, dv),
        n (L, B, H, dk), m (L, B, H) and conv (L, B, K-1, d_inner); for the
        sLSTM s h, c, n, m (L, B, H, hd).  No leaf depends on seq_len."""
        if dcfg.tp_size != 1:
            _unported(f"serving at tp={dcfg.tp_size}")
        cfg = self.cfg
        L, B, H, dk = self.n_steps, batch_local, self.n_heads, self.dk
        hd = cfg.d_model // H

        def meta(*shape):
            return torch.empty((L, *shape), dtype=torch.float32,
                               device="meta")

        one = {f"m{i}": {"C": meta(B, H, dk, dk), "n": meta(B, H, dk),
                         "m": meta(B, H),
                         "conv": meta(B, cfg.ssm_conv - 1, self.d_inner)}
               for i in range(self.per - 1)}
        one["s"] = {k: meta(B, H, hd) for k in SLSTM_STATE}
        return one

    def _final_logits(self, params, x):
        """Final norm and fp32 logits of the last position of x (B, S, d):
        the norm is row-wise, so normalising only that position is exact."""
        x = LY.rmsnorm(x[:, -1:].contiguous(), params["final_norm"],
                       self.cfg.norm_eps)
        return LY.logits_f32(x, params["head"], self.cfg)[:, 0]

    def _run(self, params, cache, x, fresh: bool):
        """Every sub-block over x, from the cache's states (`fresh`: from
        the empty state instead), writing the states after x back into
        the cache."""
        for li in range(self.n_steps):
            p = tree_map(lambda a: a[li], params["blocks"])
            for key in [f"m{i}" for i in range(self.per - 1)] + ["s"]:
                layer = cache[key]
                st = None if fresh else {k: a[li] for k, a in layer.items()}
                fn = self._slstm if key == "s" else self._mlstm
                x, new = fn(p[key], x, st)
                for k, a in layer.items():
                    a[li].copy_(new[k])
        return x

    def prefill_local(self, params, batch, dcfg: DistConfig, cache):
        """params: full params, blocks stacked (n_steps, ...); batch:
        {"tokens": (B, p) int64}, p >= ssm_conv - 1; cache:
        `train.serve.alloc_cache`'s state (`init_state`), which this call
        fills with every sub-block's state after the prompt.

        Returns (last-position logits (B, V) fp32, cache)."""
        x = LY.embed_apply(params["embed"], batch["tokens"], self.cfg, dcfg)
        x = self._run(params, cache, x, fresh=True)
        return self._final_logits(params, x), cache

    def decode_local(self, params, cache, tok, pos, dcfg: DistConfig):
        """One decode step. tok: (B,) int64; pos: (B,) (unused: the state
        carries the position).  cache: as `prefill_local`'s, updated in
        place.  Returns (logits (B, V) fp32, cache)."""
        x = LY.embed_apply(params["embed"], tok[:, None], self.cfg, dcfg)
        x = self._run(params, cache, x, fresh=False)
        return self._final_logits(params, x), cache
