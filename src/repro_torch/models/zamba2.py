"""Zamba2 hybrid family (zamba2-1.2b), training and serving (port of
`repro.models.zamba2`): a Mamba-2 backbone plus ONE weight-tied ("shared")
attention block invoked after every `shared_attn_every` Mamba layers
(arXiv:2411.15242).

Structure: the n_layers Mamba layers run as n_super superblocks of `per`
layers, each through `core/stack.apply_stack` (so bucketing, remat and the
prefetch stack apply), followed by the shared block on concat(hidden,
initial embedding) (2d wide) projected back to d; a trailing partial
superblock runs without a shared block after it.  The shared block's
params are FSDP-gathered per invocation and its gradients sum over the
invocations through ordinary autograd.

The Mamba layers call the SSD kernel (`kernels/ssd/ops.ssd`); the
reference calls the plain `ref.ssd_chunked` and never its own kernel, so
the port is held against that function.  Per-head gated RMSNorm stays in
plain torch, as in the reference.

Serving keeps O(1) state a Mamba layer: `prefill_local` runs the prompt
through `ops.ssd_with_state` (the kernels' final state on the card) and
fills the cache that `train.serve.alloc_cache` made (`init_state`'s
layout: each layer's SSD state and its two conv states, fp32, and each
shared-block invocation's keys and values); `decode_local` advances one
token per row through `ref.ssd_step` (plain torch: the reference's is
plain lax, no kernel) and the conv states, and attends over the shared
block's cache in plain torch, as the dense decode does.  Both update the
cache in place.  The cache's capacity T may exceed the prompt: a prefill of
p <= T tokens fills keys and values at [:, :p], so a decode at position p
is right (the reference's cache is the prompt's length, and its decode
drops a write past it).

Simplifications of the reference kept (DESIGN.md there): shared-block LoRA
adapters omitted; per-head RMSNorm instead of a full-d_inner groupnorm.
Not ported yet, each raising "not yet ported": the pipeline-stage contract
(`stage_spec` / `stage_blocks`, pp > 1) and tp > 1.
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
from repro_torch.core.remat import maybe_remat, whole_block_policy
from repro_torch.core.stack import apply_stack
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import layers as LY
from repro_torch.models.common import ArchConfig, InputSpec, ShapeConfig
from repro_torch.models.xlstm import causal_conv1d


def _unported(what: str):
    raise NotImplementedError(
        f"zamba2 {what} is not yet ported to repro_torch (training at pp=1, "
        "tp=1 is)")


class Zamba2LM:
    def __init__(self, cfg: ArchConfig):
        if cfg.family != "zamba":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not zamba")
        self.cfg = cfg
        self.d_inner = cfg.ssm_expand * cfg.d_model
        self.hd = cfg.ssm_head_dim
        self.nh = self.d_inner // self.hd            # mamba heads
        self.ds = cfg.ssm_state
        self.per = cfg.shared_attn_every or 6
        self.n_super = cfg.n_layers // self.per      # full superblocks
        self.n_tail = cfg.n_layers - self.n_super * self.per
        self.n_steps = cfg.n_layers                  # logical layer count
        # the shared block's attention as a dense config 2d wide
        self.shared_cfg = ArchConfig(
            name="zshared", family="dense", n_layers=cfg.n_layers,
            d_model=2 * cfg.d_model, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab,
            head_dim=cfg.head_dim, pad_to=cfg.pad_to)

    # ------------------------------------------------------------- metas --
    def mamba_metas(self, dcfg: DistConfig, dt=None) -> dict:
        cfg = self.cfg
        d, nh, hd, ds = cfg.d_model, self.nh, self.hd, self.ds
        dt = dt or dcfg.storage_dtype
        K = cfg.ssm_conv
        return {
            "ln": LY.norm_meta("ln", d, dt),
            "w_x": ParamMeta("w_x", (d, nh, hd), 1, dt),
            "w_z": ParamMeta("w_z", (d, nh, hd), 1, dt),
            "w_bc": ParamMeta("w_bc", (d, 2 * ds), None, dt),
            "w_dt": ParamMeta("w_dt", (d, nh), 1, dt),
            "dt_bias": ParamMeta("dt_bias", (nh,), 0, dt),
            "A_log": ParamMeta("A_log", (nh,), 0, dt),
            "Dskip": ParamMeta("Dskip", (nh,), 0, dt),
            "conv_x": ParamMeta("conv_x", (K, nh, hd), 1, dt),
            "conv_bc": ParamMeta("conv_bc", (K, 2 * ds), None, dt),
            "gn": ParamMeta("gn", (nh, hd), 0, dt),
            "w_out": ParamMeta("w_out", (nh, hd, d), 0, dt),
        }

    def shared_metas(self, dcfg: DistConfig) -> dict:
        cfg = self.cfg
        dt = dcfg.storage_dtype
        d2 = 2 * cfg.d_model
        lay = cfg.gqa_layout(dcfg.tp_size)
        hq, kvp = lay["hq"], lay["kvp"]
        hd = cfg.head_dim
        kv_tp = 0 if lay["mode"] == "sharded" else None
        return {
            "ln1": LY.norm_meta("sh.ln1", d2, dt),
            "wq": ParamMeta("sh.wq", (d2, hq * hd), 1, dt),
            "wk": ParamMeta("sh.wk", (kvp * hd, d2), kv_tp, dt),
            "wv": ParamMeta("sh.wv", (kvp * hd, d2), kv_tp, dt),
            "wo": ParamMeta("sh.wo", (hq * hd, cfg.d_model), 0, dt),
            "ln2": LY.norm_meta("sh.ln2", d2, dt),
            "wg": ParamMeta("sh.wg", (d2, cfg.d_ff), 1, dt),
            "wu": ParamMeta("sh.wu", (d2, cfg.d_ff), 1, dt),
            "wd": ParamMeta("sh.wd", (cfg.d_ff, cfg.d_model), 0, dt),
        }

    def block_metas(self, dcfg: DistConfig) -> dict:
        return self.mamba_metas(dcfg)

    def metas(self, dcfg: DistConfig) -> dict:
        cfg = self.cfg
        dt = dcfg.storage_dtype
        return {
            "embed": LY.embed_meta("embed", cfg, dt),
            "blocks": self.block_metas(dcfg),      # stacked over n_layers
            "shared": self.shared_metas(dcfg),
            "final_norm": LY.norm_meta("final_norm", cfg.d_model, dt),
            "head": LY.head_meta("head", cfg, dt),
        }

    @property
    def stacked_keys(self) -> dict:
        return {"blocks": self.n_steps}

    def n_params(self) -> int:
        """Sum of the metas' global sizes (the blocks once per layer)."""
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

    def stage_blocks(self, *a, **k):
        _unported("stage_blocks (pipeline stages)")

    def block_stats(self, dcfg: DistConfig, batch_shape) -> BlockStats:
        """Per-layer workload of one Mamba block for auto-wrapping, per
        device (analytic)."""
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

    # -------------------------------------------------------------- init --
    def mamba_init(self, generator, device, dtype) -> dict:
        """One Mamba layer with the reference's distributions."""
        cfg = self.cfg
        d, nh, hd, ds = cfg.d_model, self.nh, self.hd, self.ds
        K = cfg.ssm_conv
        sd = 0.02

        def normal(shape, std):
            return LY._normal(shape, std, generator, device, dtype)

        u = torch.empty((nh,), device=device, dtype=torch.float32).uniform_(
            math.log(1e-3), math.log(1e-1), generator=generator)
        dt_bias = torch.log(torch.expm1(torch.exp(u)))
        return {
            "ln": LY.norm_init(d, device, dtype),
            "w_x": normal((d, nh, hd), sd),
            "w_z": normal((d, nh, hd), sd),
            "w_bc": normal((d, 2 * ds), sd),
            "w_dt": normal((d, nh), sd),
            "dt_bias": dt_bias.to(dtype),
            "A_log": torch.log(torch.arange(1, nh + 1, device=device,
                                            dtype=torch.float32)).to(dtype),
            "Dskip": torch.ones((nh,), device=device, dtype=dtype),
            "conv_x": normal((K, nh, hd), 1.0 / math.sqrt(K)),
            "conv_bc": normal((K, 2 * ds), 1.0 / math.sqrt(K)),
            "gn": torch.ones((nh, hd), device=device, dtype=dtype),
            "w_out": normal((nh, hd, d), sd / math.sqrt(2 * cfg.n_layers)),
        }

    def shared_init(self, generator, dcfg, device, dtype) -> dict:
        cfg = self.cfg
        d2 = 2 * cfg.d_model
        lay = cfg.gqa_layout(dcfg.tp_size)
        hq, kvp = lay["hq"], lay["kvp"]
        sd = 0.02
        hd = cfg.head_dim

        def normal(shape, std):
            return LY._normal(shape, std, generator, device, dtype)

        return {
            "ln1": LY.norm_init(d2, device, dtype),
            "wq": normal((d2, hq * hd), sd),
            "wk": normal((kvp * hd, d2), sd),
            "wv": normal((kvp * hd, d2), sd),
            "wo": normal((hq * hd, cfg.d_model), sd * 0.5),
            "ln2": LY.norm_init(d2, device, dtype),
            "wg": normal((d2, cfg.d_ff), sd),
            "wu": normal((d2, cfg.d_ff), sd),
            "wd": normal((cfg.d_ff, cfg.d_model), sd * 0.5),
        }

    def init_full(self, generator: torch.Generator, dcfg: DistConfig,
                  device, dtype: torch.dtype) -> dict:
        """Full params with the reference's distributions, made on `device`
        in `dtype` one layer at a time."""
        cfg = self.cfg
        blocks = tree_map(
            lambda m: torch.empty((self.n_steps, *m.global_shape),
                                  device=device, dtype=dtype),
            self.block_metas(dcfg))
        for i in range(self.n_steps):
            tree_map(lambda dst, src: dst[i].copy_(src), blocks,
                     self.mamba_init(generator, device, dtype))
        return {
            "embed": LY.embed_init(generator, cfg, device, dtype),
            "blocks": blocks,
            "shared": self.shared_init(generator, dcfg, device, dtype),
            "final_norm": LY.norm_init(cfg.d_model, device, dtype),
            "head": LY.head_init(generator, cfg, device, dtype),
        }

    # ------------------------------------------------------------- mamba --
    def _mamba_proj(self, p, x):
        """The layer's norm and input projections of x (B,T,d): (xh
        (B,T,nh*hd), z (B,T,nh,hd), bc (B,T,2ds), dt_pre (B,T,nh))."""
        nh, hd = p["w_x"].shape[1], self.hd
        h = LY.rmsnorm(x, p["ln"], self.cfg.norm_eps)
        B, T, d = h.shape
        xh = torch.matmul(h, p["w_x"].reshape(d, nh * hd))
        z = torch.matmul(h, p["w_z"].reshape(d, nh * hd)).view(B, T, nh, hd)
        return (xh, z, torch.matmul(h, p["w_bc"]),
                torch.matmul(h, p["w_dt"]))

    def _mamba_out(self, p, x, y, z):
        """x + the output projection of y (B,T,nh,hd) through the gated
        per-head RMSNorm, in x's dtype."""
        B, T, nh, hd = y.shape
        y = y * F.silu(z)
        yf = y.float()
        var = yf.pow(2).mean(-1, keepdim=True)
        y = (yf * torch.rsqrt(var + self.cfg.norm_eps)
             * p["gn"][None, None].float()).to(x.dtype)
        return x + torch.matmul(y.reshape(B, T, nh * hd),
                                p["w_out"].reshape(nh * hd, -1))

    def _mamba(self, p, x, ssd):
        """One Mamba layer over x (B,T,d) around `ssd(xh, dt, A, Bm, Cm, D,
        chunk)` -> (y, S).  Returns (output, S, and the conv states: the
        last K-1 inputs of each causal conv, zeros before the sequence)."""
        cfg = self.cfg
        nh, hd, ds = p["w_x"].shape[1], self.hd, self.ds
        xh, z, bc, dt_pre = self._mamba_proj(p, x)
        B, T, _ = x.shape
        # causal convs (x per head channel, bc shared)
        xh2, cx = causal_conv1d(xh, p["conv_x"].reshape(-1, nh * hd))
        xh = F.silu(xh2).view(B, T, nh, hd)
        bc2, cbc = causal_conv1d(bc, p["conv_bc"])
        bc = F.silu(bc2)
        Bm = bc[..., :ds][:, :, None, :]                     # (B,T,1,ds)
        Cm = bc[..., ds:][:, :, None, :]
        dt = F.softplus(dt_pre.float() + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())
        y, S = ssd(xh, dt, A, Bm, Cm, p["Dskip"], cfg.ssm_chunk)
        return self._mamba_out(p, x, y, z), S, cx, cbc

    def mamba_block(self, p, consts, x, dcfg: DistConfig):
        return self._mamba(p, x, lambda *a: (ssd_ops.ssd(*a), None))[0]

    def _mamba_stack_fn(self, p, consts, x, dcfg, inner_remat=False):
        if inner_remat:
            return checkpoint(self.mamba_block, p, consts, x, dcfg,
                              use_reentrant=False), {}
        return self.mamba_block(p, consts, x, dcfg), {}

    def _run_stack(self, seg, consts, x, dcfg: DistConfig, plan=None):
        """One run of Mamba layers through `apply_stack`, with the blocks'
        bucket `plan` (without one the stack resolves it).

        The reference wraps every Mamba block in `jax.checkpoint` inside
        the stack's own policy: each layer saves its input (and, under
        remat="none", its gathered params) and recomputes the block in the
        backward; under fsdp_only / full / save_dots the gather is
        recomputed too.  On the vanilla schedule the port gets the same
        schedule from one wrap: under "none" the block is checkpointed
        inside the layer (the gathered params stay, as the reference's
        inner checkpoint keeps its inputs), otherwise the whole layer,
        gather included, is checkpointed ("full").  A torch checkpoint of
        the block inside the fsdp_only scope would hold the gathered params
        for its recompute, so they would never be dropped.  Under the
        prefetch stack the backward already recomputes every layer from
        its saved input, so an inner checkpoint would only add a third
        forward: it is left out, and the stack's own policy applies.  The
        choice changes memory and time, not values."""
        # without a plan the planners price this rank's (B, S) workload,
        # as plan_parallel does (the reference plans its runtime without
        # block_stats, so under comm_precision='auto' it can run another
        # plan than the one it reports)
        stats = self.block_stats(dcfg, tuple(x.shape[:2]))
        if dcfg.reorder:
            blk = functools.partial(self._mamba_stack_fn, dcfg=dcfg)
            return apply_stack(blk, self.block_metas(dcfg), dcfg, seg,
                               consts, x, plan=plan, block_stats=stats)[0]
        inner = whole_block_policy(dcfg.remat) == "none"
        blk = functools.partial(self._mamba_stack_fn, dcfg=dcfg,
                                inner_remat=inner)
        return apply_stack(blk, self.block_metas(dcfg), dcfg, seg, consts, x,
                           plan=plan, block_stats=stats,
                           remat=("none" if inner else "full",))[0]

    # ------------------------------------------------------ shared block --
    def _shared_qkv(self, p, x, emb, dcfg):
        """The shared block's norm of concat(hidden, embedding) (B,S,2d)
        and its projections: q, k, v (before RoPE), head_mask."""
        h = LY.rmsnorm(torch.cat([x, emb], dim=-1), p["ln1"],
                       self.cfg.norm_eps)
        return LY._local_qkv({"wq": p["wq"], "wk": p["wk"], "wv": p["wv"]},
                             h, self.shared_cfg, dcfg)

    def _shared_out(self, p, x, emb, out):
        """x + the projection of the attention's out (B,S,hl,hd); -> mlp on
        concat(x, embedding) -> +x."""
        Bq, S, hl, hd = out.shape
        x = x + torch.matmul(out.reshape(Bq, S, hl * hd), p["wo"])
        h = LY.rmsnorm(torch.cat([x, emb], dim=-1), p["ln2"],
                       self.cfg.norm_eps)
        g = torch.matmul(h, p["wg"])
        w = torch.matmul(h, p["wu"])
        return x + torch.matmul(F.silu(g) * w, p["wd"])

    def _shared_prefill(self, p, x, emb, consts, dcfg: DistConfig):
        """concat(hidden, embedding) -> attn -> +x ; -> mlp -> +x.  Returns
        (output, (keys after RoPE, values) (B,S,kv heads,hd))."""
        q, k, v, head_mask = self._shared_qkv(p, x, emb, dcfg)
        cos, sin = consts["rope_cos"], consts["rope_sin"]
        q = LY.apply_rope(q, cos, sin)
        k = LY.apply_rope(k, cos, sin)
        out = LY.attention(q, k, v, causal=True)
        return self._shared_out(p, x, emb,
                                out * head_mask[None, None, :, None]), (k, v)

    def shared_block(self, p, x, emb, consts, dcfg: DistConfig):
        return self._shared_prefill(p, x, emb, consts, dcfg)[0]

    # ------------------------------------------------------------- train --
    def _shared_fn(self, consts, dcfg: DistConfig):
        """FSDP-gathering applier of the weight-tied shared block: its
        params gathered per invocation (one collective a leaf), the whole
        invocation under 'full' remat unless remat is 'none' (the block
        touches the 2d-wide concat; recomputing beats saving it)."""
        sh_metas = self.shared_metas(dcfg)

        def shared_fn(sh_storage, xc, embc):
            sh = coll.replicate_tree(sh_storage, sh_metas, dcfg)
            return self.shared_block(sh, xc, embc, consts, dcfg)

        return maybe_remat(shared_fn, "full"
                           if whole_block_policy(dcfg.remat) != "none"
                           else "none")

    def consts(self, seq_len: int, device) -> dict:
        cos, sin = LY.rope_cache(seq_len, self.cfg.head_dim,
                                 self.cfg.rope_theta, device)
        return {"rope_cos": cos, "rope_sin": sin}

    def stage_pre(self, storage, mb, dcfg: DistConfig):
        cfg = self.cfg
        emb_meta = LY.embed_meta("embed", cfg, dcfg.storage_dtype)

        def embed_fn(shard, ids):
            table = coll.replicate(shard, emb_meta, dcfg)
            return LY.embed_apply(table, ids, cfg, dcfg)

        x = maybe_remat(embed_fn, "fsdp_only")(storage["embed"],
                                               mb["tokens"])
        # the shared block re-reads the initial embedding every superblock
        return {"x": x, "emb0": x}

    def stage_loss(self, storage, state, mb, dcfg: DistConfig):
        cfg = self.cfg
        fn_meta = LY.norm_meta("final_norm", cfg.d_model, dcfg.storage_dtype)
        w_fn = coll.replicate(storage["final_norm"], fn_meta, dcfg)
        x = LY.rmsnorm(state["x"], w_fn, cfg.norm_eps)
        hd_meta = LY.head_meta("head", cfg, dcfg.storage_dtype)
        w = coll.replicate(storage["head"], hd_meta, dcfg)
        loss, _ = LY.vocab_parallel_xent(LY.logits_f32(x, w, cfg),
                                         mb["targets"], mb["valid"])
        return loss

    def loss_local(self, storage, batch, dcfg: DistConfig, plan=None):
        """Full superblocks, each followed by the shared block, then the
        trailing partial superblock (no shared block after it).  Returns
        (this rank's masked mean loss, aux).  `plan`: the blocks' bucket
        plan (`_run_stack`)."""
        state = self.stage_pre(storage, batch, dcfg)
        x, emb0 = state["x"], state["emb0"]
        consts = self.consts(x.shape[1], x.device)
        shared_fn = self._shared_fn(consts, dcfg)
        sizes = self._segments()
        # one split per stacked leaf: its backward joins the runs' layer
        # gradients once
        runs = tree_map(lambda a: a.split(sizes, 0), storage["blocks"])
        for g in range(len(sizes)):
            seg = tree_map(lambda parts: parts[g], runs)
            x = self._run_stack(seg, consts, x, dcfg, plan)
            if g < self.n_super:
                x = shared_fn(storage["shared"], x, emb0)
        loss = self.stage_loss(storage, {"x": x, "emb0": emb0}, batch, dcfg)
        return loss, {}


    # ------------------------------------------------------------- serve --
    def _segments(self) -> list:
        """Mamba layers a run: the full superblocks (each followed by the
        shared block), then the tail."""
        return [self.per] * self.n_super + ([self.n_tail]
                                            if self.n_tail else [])

    def init_state(self, batch_local: int, dcfg: DistConfig,
                   seq_len: int = 0) -> dict:
        """The serving state's leaves on the meta device (shapes and dtypes;
        `train.serve.alloc_cache` makes them), laid out as the reference's
        `init_state` at tp = 1: S (L, B, nh, hd, ds), conv_x (L, B, K-1,
        nh*hd) and conv_bc (L, B, K-1, 2 ds) fp32, and sh_kv, n_super (k,
        v) pairs of (B, seq_len, kv heads, hd) in param_dtype."""
        cfg = self.cfg
        if dcfg.tp_size != 1:
            _unported(f"serving at tp={dcfg.tp_size}")
        L, B, K = cfg.n_layers, batch_local, cfg.ssm_conv
        kv = (B, seq_len, cfg.gqa_layout(1)["kvp"], cfg.head_dim)

        def meta(shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="meta")

        return {
            "S": meta((L, B, self.nh, self.hd, self.ds)),
            "conv_x": meta((L, B, K - 1, self.nh * self.hd)),
            "conv_bc": meta((L, B, K - 1, 2 * self.ds)),
            "sh_kv": tuple((meta(kv, dcfg.param_dtype),
                            meta(kv, dcfg.param_dtype))
                           for _ in range(self.n_super)),
        }

    def _final_logits(self, params, x):
        """Final norm and fp32 logits of the last position of x (B, S, d):
        the norm is row-wise, so normalising only that position is exact."""
        x = LY.rmsnorm(x[:, -1:].contiguous(), params["final_norm"],
                       self.cfg.norm_eps)
        return LY.logits_f32(x, params["head"], self.cfg)[:, 0]

    def prefill_local(self, params, batch, dcfg: DistConfig, cache):
        """params: full params, blocks stacked (n_layers, ...); batch:
        {"tokens": (B, p) int64}; cache: `train.serve.alloc_cache`'s state
        (`init_state`) of capacity T >= p, which this call fills: every
        layer's SSD state after the prompt and its conv states, and each
        shared-block invocation's keys and values at [:, :p].

        Returns (last-position logits (B, V) fp32, cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        n = tokens.shape[1]
        if self.n_super and n > cache["sh_kv"][0][0].shape[1]:
            raise ValueError(f"a prompt of {n} tokens, a cache of "
                             f"{cache['sh_kv'][0][0].shape[1]}")
        x = LY.embed_apply(params["embed"], tokens, cfg, dcfg)
        emb0 = x
        consts = self.consts(n, tokens.device)
        li = 0
        for g, size in enumerate(self._segments()):
            for _ in range(size):
                p = tree_map(lambda a: a[li], params["blocks"])
                x, S, cx, cbc = self._mamba(p, x, ssd_ops.ssd_with_state)
                for key, v in (("S", S), ("conv_x", cx), ("conv_bc", cbc)):
                    cache[key][li].copy_(v)
                li += 1
            if g < self.n_super:
                x, kv = self._shared_prefill(params["shared"], x, emb0,
                                             consts, dcfg)
                for leaf, v in zip(cache["sh_kv"][g], kv):
                    leaf[:, :n].copy_(v)
        return self._final_logits(params, x), cache

    def mamba_decode(self, p, st, x):
        """One Mamba layer for one token a row, x (B,1,d), from the layer's
        state st {"S", "conv_x", "conv_bc"}.  Returns (output, S, conv_x,
        conv_bc), the states fp32."""
        nh, hd, ds = p["w_x"].shape[1], self.hd, self.ds
        xh, z, bc, dt_pre = self._mamba_proj(p, x)
        B = x.shape[0]
        xh2, cx = causal_conv1d(xh, p["conv_x"].reshape(-1, nh * hd),
                                state=st["conv_x"].to(xh.dtype))
        xh = F.silu(xh2).view(B, nh, hd)
        bc2, cbc = causal_conv1d(bc, p["conv_bc"],
                                 state=st["conv_bc"].to(bc.dtype))
        bc = F.silu(bc2)[:, 0]
        dt = F.softplus(dt_pre[:, 0].float() + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())
        S, y = ssd_ref.ssd_step(st["S"], xh, dt, A, bc[:, None, :ds],
                                bc[:, None, ds:], D=p["Dskip"])
        return (self._mamba_out(p, x, y[:, None], z), S, cx.float(),
                cbc.float())

    def _shared_decode(self, p, kv, x, emb0, pos, cos, sin, dcfg):
        """The shared block for one token a row at positions pos (B,):
        writes its key and value into kv (this invocation's (k, v) cache,
        in place) and attends over the cache at <= pos in plain torch with
        fp32 scores, as the reference's einsums do."""
        cfg = self.cfg
        q, k, v, head_mask = self._shared_qkv(p, x, emb0, dcfg)
        q = LY.apply_rope_pos(q, cos, sin)
        k = LY.apply_rope_pos(k, cos, sin)
        ck, cv = kv
        B, hd = q.shape[0], cfg.head_dim
        ib = torch.arange(B, device=x.device)
        ck[ib, pos] = k[:, 0].to(ck.dtype)
        cv[ib, pos] = v[:, 0].to(cv.dtype)
        out = LY.cached_attention(q / math.sqrt(hd), ck, cv, pos[:, None])
        out = out * head_mask[None, None, :, None]
        return self._shared_out(p, x, emb0, out)

    def decode_local(self, params, cache, tok, pos, dcfg: DistConfig):
        """One decode step. tok: (B,) int64; pos: (B,) int64 per-row
        positions (< the cache's capacity).  cache: as `prefill_local`'s,
        updated in place.  Returns (logits (B, V) fp32, cache)."""
        cfg = self.cfg
        x = LY.embed_apply(params["embed"], tok[:, None], cfg, dcfg)
        emb0 = x
        cos, sin = LY.rope_pos(pos[:, None], cfg.head_dim, cfg.rope_theta)
        li = 0
        for g, size in enumerate(self._segments()):
            for _ in range(size):
                p = tree_map(lambda a: a[li], params["blocks"])
                st = {k: cache[k][li] for k in ("S", "conv_x", "conv_bc")}
                x, *new = self.mamba_decode(p, st, x)
                for key, v in zip(("S", "conv_x", "conv_bc"), new):
                    cache[key][li].copy_(v)
                li += 1
            if g < self.n_super:
                x = self._shared_decode(params["shared"], cache["sh_kv"][g],
                                        x, emb0, pos, cos, sin, dcfg)
        return self._final_logits(params, x), cache
