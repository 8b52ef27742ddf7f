"""Dense decoder-only LM (port of `repro.models.dense`).

Runs llama3-style blocks (RoPE, SwiGLU, GQA) with the variants the configs
set: qk-norm and tied embeddings (qwen3), and gemma2's local/global pairs
(a sliding-window layer then a global one, stacked as ONE step of the
layer stack so its leaves stay homogeneous), sandwich norms (pre and post,
unit offset), the sqrt(d) embedding scale, query_pre_attn scaling, GeGLU
and the attention and final logit softcaps.  A config with a sliding
window and no pairs applies the window on every layer.  The FFN is a hook
(`_ffn_metas` / `_ffn_init` / `_ffn_apply` / `_ffn_decode`) that the moe
family overrides; its per-layer aux (the router's load-balance loss)
rides the stack's aux channel and `_loss_aux` adds it to the loss.

Parameters are plain dicts with the reference's tree and layouts; the
block leaves are stacked on a leading (n_steps, ...) axis, and a gemma2
step holds {"local": ..., "global": ...}.  Entry points:
  loss_local    — training forward + masked cross-entropy on the flat
                  ZeRO-3 storage shards (FSDP via core/stack), at pp=1;
                  composed of the stage contract stage_pre / stage_blocks /
                  stage_loss;
  prefill_local — serving: embed a (B, T) batch, run every block, write
                  the KV cache, return the last-position logits;
  decode_local  — serving: one token per row at per-row positions;
  paged_step_local — serving from a paged arena (core/serving): a decode
                  step or a prefill chunk, through the same cached core.
A KV codec (`DistConfig.kv_codec`) stores the cache as int8 / fp8 wire
values with per-128-chunk scales through the quant kernels.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import collectives as coll
from repro_torch.core.dist import DistConfig
from repro_torch.core.irgraph import BlockStats
from repro_torch.core.meta import named_leaves, tree_map
from repro_torch.core.remat import maybe_remat
from repro_torch.core.serving import pages as PG
from repro_torch.core.stack import apply_stack
from repro_torch.models import layers as LY
from repro_torch.models.common import (ArchConfig, BlockSegments, InputSpec,
                                       ShapeConfig)


class DenseLM:
    family = "dense"

    def __init__(self, cfg: ArchConfig):
        if cfg.family != self.family or cfg.gated_mlp not in LY.GATED_MLPS:
            raise NotImplementedError(
                f"{cfg.name}: family={cfg.family} gated_mlp={cfg.gated_mlp} "
                "is not ported to repro_torch")
        self.cfg = cfg
        # gemma2 alternates (local, global): one stack step is the pair
        self.layers_per_step = 2 if cfg.local_global_alternate else 1
        if cfg.n_layers % self.layers_per_step:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                             "make whole local/global pairs")
        self.n_steps = cfg.n_layers // self.layers_per_step
        # a measured BlockStats override: when set, block_stats() returns
        # it instead of the analytic model
        self.measured_stats: BlockStats | None = None

    @property
    def _subs(self) -> tuple:
        """(key into a step's params, attention window) of each layer of
        one stack step: the key is None where a step is one layer."""
        w = self.cfg.sliding_window
        if self.layers_per_step == 1:
            return ((None, w),)
        return (("local", w), ("global", None))

    def _sub_caches(self, cache) -> list:
        """One step's (k, v) cache pair per layer of `_subs`."""
        return [cache] if self.layers_per_step == 1 else list(cache)

    # ------------------------------------------------------------- metas --
    def _sub_metas(self, dcfg: DistConfig, tag: str) -> dict:
        cfg, dt = self.cfg, dcfg.storage_dtype
        m = {
            "ln1": LY.norm_meta(f"{tag}ln1", cfg.d_model, dt),
            "attn": LY.attn_metas(cfg, dcfg, dt, prefix=f"{tag}attn."),
            "ln2": LY.norm_meta(f"{tag}ln2", cfg.d_model, dt),
            "mlp": self._ffn_metas(dcfg, dt, prefix=f"{tag}mlp."),
        }
        if cfg.post_norms:
            m["pn1"] = LY.norm_meta(f"{tag}pn1", cfg.d_model, dt)
            m["pn2"] = LY.norm_meta(f"{tag}pn2", cfg.d_model, dt)
        return m

    def block_metas(self, dcfg: DistConfig) -> dict:
        if self.layers_per_step == 1:
            return self._sub_metas(dcfg, "")
        return {k: self._sub_metas(dcfg, f"{k}.") for k, _ in self._subs}

    def metas(self, dcfg: DistConfig) -> dict:
        cfg, dt = self.cfg, dcfg.storage_dtype
        m = {
            "embed": LY.embed_meta("embed", cfg, dt),
            "blocks": self.block_metas(dcfg),
            "final_norm": LY.norm_meta("final_norm", cfg.d_model, dt),
        }
        if not cfg.tie_embeddings:
            m["head"] = LY.head_meta("head", cfg, dt)
        return m

    @property
    def stacked_keys(self) -> dict:
        """Top-level param groups carrying a leading layer-stack dim."""
        return {"blocks": self.n_steps}

    def input_specs(self, shape: ShapeConfig, dcfg: DistConfig) -> dict:
        B, S = shape.global_batch, shape.seq_len
        if shape.kind != "train":
            raise NotImplementedError(
                f"input_specs for kind={shape.kind!r}: the serving steps "
                "take their inputs directly")
        return {"tokens": InputSpec((B, S), "int32"),
                "targets": InputSpec((B, S), "int32"),
                "valid": InputSpec((B, S), "float32")}

    # -------------------------------------------------------------- init --
    def _sub_init(self, generator, dcfg, device, dtype) -> dict:
        # gemma-style norms store (w - 1) and start at zeros
        cfg, uo = self.cfg, self.cfg.post_norms
        p = {
            "ln1": LY.norm_init(cfg.d_model, device, dtype, uo),
            "attn": LY.attn_init(generator, cfg, dcfg, device, dtype),
            "ln2": LY.norm_init(cfg.d_model, device, dtype, uo),
            "mlp": self._ffn_init(generator, dcfg, device, dtype),
        }
        if uo:
            p["pn1"] = LY.norm_init(cfg.d_model, device, dtype, True)
            p["pn2"] = LY.norm_init(cfg.d_model, device, dtype, True)
        return p

    def init_block_full(self, generator, dcfg, device, dtype) -> dict:
        if self.layers_per_step == 1:
            return self._sub_init(generator, dcfg, device, dtype)
        return {k: self._sub_init(generator, dcfg, device, dtype)
                for k, _ in self._subs}

    def init_full(self, generator: torch.Generator, dcfg: DistConfig,
                  device, dtype: torch.dtype) -> dict:
        """Full params with the reference's distributions, made on `device`
        in `dtype` one layer at a time (a full-width model never exists in
        fp32 or on the host)."""
        cfg = self.cfg
        blocks = tree_map(
            lambda m: torch.empty((self.n_steps, *m.global_shape),
                                  device=device, dtype=dtype),
            self.block_metas(dcfg))
        for i in range(self.n_steps):
            tree_map(lambda dst, src: dst[i].copy_(src), blocks,
                     self.init_block_full(generator, dcfg, device, dtype))
        p = {
            "embed": LY.embed_init(generator, cfg, device, dtype),
            "blocks": blocks,
            "final_norm": LY.norm_init(cfg.d_model, device, dtype,
                                       cfg.post_norms),
        }
        if not cfg.tie_embeddings:
            p["head"] = LY.head_init(generator, cfg, device, dtype)
        return p

    def consts(self, seq_len: int, device) -> dict:
        cos, sin = LY.rope_cache(seq_len, self.cfg.head_dim,
                                 self.cfg.rope_theta, device)
        return {"rope_cos": cos, "rope_sin": sin}

    # ------------------------------------------------------------- block --
    @property
    def _q_scale(self):
        if self.cfg.name.startswith("gemma2"):
            return 256.0 ** -0.5      # query_pre_attn_scalar
        return 1.0 / math.sqrt(self.cfg.head_dim)

    @property
    def _embed_scale(self):
        return math.sqrt(self.cfg.d_model) if self.cfg.post_norms else None

    def _norm(self, x, w):
        """The block norms: unit offset under gemma2's sandwich norms."""
        return LY.rmsnorm(x, w, self.cfg.norm_eps, self.cfg.post_norms)

    def _attn_half(self, p, rope, x, dcfg, window):
        """Attention residual branch (ln1 + attn.* (+ pn1)): (x + h,
        (k, v))."""
        h = self._norm(x, p["ln1"])
        h, kv = LY.attn_apply(p["attn"], h, rope, self.cfg, dcfg,
                              window=window, q_scale=self._q_scale)
        if self.cfg.post_norms:
            h = self._norm(h, p["pn1"])
        return x + h, kv

    # FFN hooks: overridden by the moe family ------------------------------
    def _ffn_metas(self, dcfg, dtype, prefix=""):
        return LY.mlp_metas(self.cfg, dcfg, dtype, prefix=prefix)

    def _ffn_init(self, generator, dcfg, device, dtype):
        return LY.mlp_init(generator, self.cfg, device, dtype)

    def _ffn_apply(self, p, x, dcfg):
        """-> (FFN output, this layer's aux dict)."""
        return LY.mlp_apply(p, x, self.cfg, dcfg), {}

    def _ffn_decode(self, p, x, dcfg):
        # the reference's decode FFN differs from its train FFN only by a
        # psum over the TP ranks, the identity at tp = 1
        return self._ffn_apply(p, x, dcfg)[0]

    def _mlp_half(self, p, x, dcfg):
        """FFN residual branch (ln2 + mlp.* (+ pn2)): (x + h, aux)."""
        h = self._norm(x, p["ln2"])
        h, aux = self._ffn_apply(p["mlp"], h, dcfg)
        if self.cfg.post_norms:
            h = self._norm(h, p["pn2"])
        return x + h, aux

    def _sub_block(self, p, rope, x, dcfg, window):
        x, _ = self._attn_half(p, rope, x, dcfg, window)
        return self._mlp_half(p, x, dcfg)

    def block_fn(self, p, consts, x, dcfg: DistConfig):
        rope = (consts["rope_cos"], consts["rope_sin"])
        if self.layers_per_step == 1:
            return self._sub_block(p, rope, x, dcfg, self.cfg.sliding_window)
        # each half of the pair is checkpointed (its input kept, the rest
        # recomputed in the backward), halving the pair's backward
        # residency as the reference's `jax.checkpoint` does
        aux = {}
        for key, window in self._subs:
            x, aux_l = checkpoint(self._sub_block, p[key], rope, x, dcfg,
                                  window, use_reentrant=False)
            aux = {k: aux.get(k, 0) + v for k, v in aux_l.items()}
        return x, aux

    def block_segments(self, dcfg: DistConfig) -> BlockSegments:
        """Segmented block contract: the attention and FFN residual
        branches of each layer of a step, in order.  The state between two
        segments of a pair is (x, aux): the local FFN's aux rides it into
        the global layer.

        The reference also wraps each pair segment in `jax.checkpoint`.
        The port's prefetch stack already recomputes every segment from its
        input state in the backward, so a checkpoint there would recompute
        each segment twice; the vanilla stack checkpoints per its remat
        policy."""
        if self.layers_per_step == 1:
            w = self.cfg.sliding_window

            def seg_attn(p, consts, x):
                return self._attn_half(p, (consts["rope_cos"],
                                           consts["rope_sin"]), x, dcfg,
                                       w)[0]

            def seg_mlp(p, consts, x):
                return self._mlp_half(p, x, dcfg)

            return BlockSegments(
                names=("attn", "mlp"),
                param_globs=(("ln1", "attn/*", "pn1"),
                             ("ln2", "mlp/*", "pn2")),
                fns=(seg_attn, seg_mlp))

        def attn(key, window, p, consts, st):
            x, aux = st if isinstance(st, tuple) else (st, {})
            x, _ = self._attn_half(p[key], (consts["rope_cos"],
                                            consts["rope_sin"]), x, dcfg,
                                   window)
            return x, aux

        def mlp(key, p, consts, st):
            x, aux = st
            y, aux2 = self._mlp_half(p[key], x, dcfg)
            return y, {k: aux.get(k, 0) + v for k, v in aux2.items()}

        names, globs, fns = [], [], []
        for key, window in self._subs:
            names += [f"{key}.attn", f"{key}.mlp"]
            globs += [(f"{key}/ln1", f"{key}/attn/*", f"{key}/pn1"),
                      (f"{key}/ln2", f"{key}/mlp/*", f"{key}/pn2")]
            fns += [functools.partial(attn, key, window),
                    functools.partial(mlp, key)]
        return BlockSegments(names=tuple(names), param_globs=tuple(globs),
                             fns=tuple(fns))

    # ----------------------------------------------------------- costing --
    def block_stats(self, dcfg: DistConfig, batch_shape) -> BlockStats:
        """Per-layer workload for auto-wrapping, per device: analytic
        (core/hw roofline) unless `measured_stats` is set."""
        if self.measured_stats is not None:
            return self.measured_stats
        cfg = self.cfg
        B, S = batch_shape          # per-device microbatch (cp-local seq)
        tokens = B * S
        d, hd = cfg.d_model, cfg.head_dim
        hq = cfg.q_heads_padded(dcfg.tp_size)
        pf, pb = {}, {}
        it = dcfg.param_dtype.itemsize
        for nm, m in named_leaves(self.block_metas(dcfg)):
            numel = m.numel_local(dcfg)
            # matmul params: 2*tokens*numel flops; norms: O(tokens*d)
            flops = 2.0 * tokens * numel if numel > 4 * d \
                else 8.0 * tokens * d / max(1, dcfg.tp_size)
            pf[nm] = flops
            pb[nm] = numel * it + flops / max(d, 1) * it
        # attention itself (not a param op) folds into the first param's
        # consumer cost; the kv span is the whole sequence (S * cp)
        attn_flops = 4.0 * tokens * (S * dcfg.cp_size) * hd \
            * (hq / dcfg.tp_size)
        first = next(iter(pf))
        pf[first] += attn_flops
        act = tokens * d * it / dcfg.tp_size
        return BlockStats(param_flops=pf, param_bytes=pb, act_bytes=act)

    def _logits(self, params, x):
        """x: (B, S, D) -> fp32 logits (B, S, V) from the full params."""
        w = params["embed"] if self.cfg.tie_embeddings else params["head"]
        return LY.logits_f32(x, w, self.cfg)

    # ------------------------------------------------------------- train --
    def _embed_in(self, storage, tokens, dcfg):
        cfg = self.cfg
        emb_meta = LY.embed_meta("embed", cfg, dcfg.storage_dtype)

        def embed_fn(emb_shard, ids):
            table = coll.replicate(emb_shard, emb_meta, dcfg)
            return LY.embed_apply(table, ids, cfg, dcfg,
                                  scale=self._embed_scale)

        return maybe_remat(embed_fn, "fsdp_only" if dcfg.remat != "none"
                           else "none")(storage["embed"], tokens)

    def _lm_head(self, storage, x, dcfg):
        cfg = self.cfg
        key = "embed" if cfg.tie_embeddings else "head"
        meta = (LY.embed_meta if cfg.tie_embeddings else LY.head_meta)(
            key, cfg, dcfg.storage_dtype)
        return LY.logits_f32(x, coll.replicate(storage[key], meta, dcfg), cfg)

    def _aux0(self) -> dict:
        """Zero-valued aux accumulator matching the stack's aux keys."""
        return {}

    def _loss_aux(self, aux):
        """Scalar added to the cross-entropy loss from the summed aux."""
        return 0.0

    # -- the stage-partition contract; composes to loss_local at pp=1
    def stage_pre(self, storage, mb, dcfg: DistConfig):
        """tokens -> embeddings (+ zero aux)."""
        return self._embed_in(storage, mb["tokens"], dcfg), self._aux0()

    def stage_blocks(self, storage, state, dcfg: DistConfig, plan=None):
        """The layer stack under the SimpleFSDP schedule (core/stack) with
        the blocks' bucket `plan`; without one the stack resolves it from
        this rank's (B, S) workload."""
        x, aux = state
        B, S = x.shape[0], x.shape[1]
        consts = self.consts(S, x.device)
        blk = functools.partial(self.block_fn, dcfg=dcfg)
        x, aux2 = apply_stack(blk, self.block_metas(dcfg), dcfg,
                              storage["blocks"], consts, x, plan=plan,
                              block_stats=self.block_stats(dcfg, (B, S)),
                              segments=self.block_segments(dcfg))
        return x, {k: aux.get(k, 0) + v for k, v in aux2.items()}

    def stage_loss(self, storage, state, mb, dcfg: DistConfig):
        """Final norm, LM head, masked cross-entropy (+ the summed aux)."""
        cfg = self.cfg
        x, aux = state
        fn_meta = LY.norm_meta("final_norm", cfg.d_model, dcfg.storage_dtype)
        w_fn = coll.replicate(storage["final_norm"], fn_meta, dcfg)
        x = self._norm(x, w_fn)
        logits = self._lm_head(storage, x, dcfg)
        loss, _ = LY.vocab_parallel_xent(logits, mb["targets"], mb["valid"])
        return loss + self._loss_aux(aux)

    def loss_local(self, storage, batch, dcfg: DistConfig, plan=None):
        """batch: tokens/targets (B, S) int, valid (B, S) fp32.  Returns
        (this rank's masked mean loss, aux).  `plan`: the blocks' bucket
        plan (`stage_blocks`)."""
        state = self.stage_blocks(storage,
                                  self.stage_pre(storage, batch, dcfg), dcfg,
                                  plan)
        return self.stage_loss(storage, state, batch, dcfg), state[1]

    # ------------------------------------------------------------- serve --
    def _serve_sub(self, p, rope, x, dcfg, window):
        """Prefill layer: returns the layer's output and its (k, v)."""
        x, kv = self._attn_half(p, rope, x, dcfg, window)
        return self._mlp_half(p, x, dcfg)[0], kv

    def _final_logits(self, params, x):
        """Final norm and logits of the last position of x (B, C, D): the
        norm is row-wise, so normalising only that position is exact."""
        x = self._norm(x[:, -1:].contiguous(), params["final_norm"])
        return self._logits(params, x)[:, 0]

    @staticmethod
    def _store_kv(kv, i, k, v, dcfg):
        """Write a prefill layer's (B, S, Kl, hd) k and v into positions 0
        .. S-1 of layer i of its cache (a capacity of T >= S positions): a
        (k, v) pair, or under a KV codec the {"k", "ks", "v", "vs"} wire
        values and scales."""
        codec = dcfg.kv_codec
        if not codec:
            kv[0][i, :, :k.shape[1]].copy_(k)
            kv[1][i, :, :v.shape[1]].copy_(v)
            return
        for name, x in (("k", k), ("v", v)):
            q, sc = LY.kv_quantize(x, codec)
            PG.put_layer(kv[name], i, q)
            kv[name + "s"][i, :, :sc.shape[1]].copy_(sc)

    def prefill_local(self, params, batch, dcfg: DistConfig, cache):
        """params: full params, blocks stacked (n_steps, ...); batch:
        {"tokens": (B, S) int64}; cache: `train.serve.alloc_cache`'s (k, v)
        pair of (n_steps, B, T, Kl, hd) buffers, T >= S (under a KV codec,
        the {"k", "ks", "v", "vs"} wire values and scales), one a layer of
        a step, whose first S positions this call fills.

        Returns (last-position logits (B, V) fp32, cache)."""
        x = LY.embed_apply(params["embed"], batch["tokens"], self.cfg, dcfg,
                           scale=self._embed_scale)
        return self._prefill_from(params, x, dcfg, cache)

    def _prefill_from(self, params, x, dcfg, cache):
        """`prefill_local` from the embedded sequence x (B, S, D): every
        block over positions 0 .. S-1, their keys and values into the
        cache, the last position's logits."""
        cfg = self.cfg
        rope = LY.rope_cache(x.shape[1], cfg.head_dim, cfg.rope_theta,
                             x.device)
        for i in range(self.n_steps):
            p = tree_map(lambda a: a[i], params["blocks"])
            for (key, window), kv in zip(self._subs,
                                         self._sub_caches(cache)):
                x, (k, v) = self._serve_sub(p[key] if key else p, rope, x,
                                            dcfg, window)
                self._store_kv(kv, i, k, v, dcfg)
        return self._final_logits(params, x), cache

    # decode -----------------------------------------------------------------
    # Paged-serving contract (core/serving): this family stores its cache
    # as fixed-size KV pages in a pooled arena and decodes through the
    # scatter / gather writer below.  The recurrent zamba2 family carries O(1)
    # state and does not page.
    paged_kv = True
    # the reference's context-parallel contract flag, read by the serving
    # plan's ring-attention prefill recommendation (`plan_serve`); the
    # port runs no context parallelism yet (core/api raises on a ctx axis)
    cp_supported = True

    @staticmethod
    def _kv_writer(kv, k, v, *, index, read, dcfg):
        """Commit new (B,C,Kl,hd) K/V IN PLACE into one layer's cache
        leaves at `index` (rows, slots) of their two leading dims, then
        return the dense read views (ck, cv) the attention consumes,
        `read` of each leaf (dequantized under a KV codec).

        Dense cache: index (batch rows, qpos), read the identity.  Paged
        arena: index (pool rows, slots) and read the table's gathered
        window (`core/serving/pages`), exactly the dense cache contents for
        every allocated position <= qpos.  The reference builds a new cache
        functionally and relies on XLA to alias it."""
        codec = dcfg.kv_codec
        if not codec:
            for leaf, val in zip(kv, (k, v)):
                PG.put_tokens(leaf, *index, val)
            return read(kv[0]), read(kv[1])
        for name, x in (("k", k), ("v", v)):
            q, sc = LY.kv_quantize(x, codec)
            PG.put_tokens(kv[name], *index, q)
            PG.put_tokens(kv[name + "s"], *index, sc)
        view = {n: read(a) for n, a in kv.items()}
        return tuple(LY.kv_dequantize(view[n], view[n + "s"],
                                      dcfg.param_dtype) for n in ("k", "v"))

    def _decode_sub(self, p, x, kv, qpos, cos, sin, dcfg, window, writer):
        """x: (B,C,D); kv: this layer's cache (dense views or page pools);
        qpos: (B,C) absolute positions per query token; `window`: this
        layer's sliding window, or None; `writer(kv, k, v)` commits the new
        K/V in place and returns the dense read views (B,T,Kl,hd).
        Attention is plain torch: the reference's einsums, with fp32
        scores."""
        cfg = self.cfg
        h = self._norm(x, p["ln1"])
        q, k, v, head_mask = LY._local_qkv(p["attn"], h, cfg, dcfg)
        if cfg.qk_norm:
            q = LY.rmsnorm(q, p["attn"]["q_norm"], cfg.norm_eps)
            k = LY.rmsnorm(k, p["attn"]["k_norm"], cfg.norm_eps)
        q = LY.apply_rope_pos(q, cos, sin)
        k = LY.apply_rope_pos(k, cos, sin)
        ck, cv = writer(kv, k, v)
        B, C = qpos.shape
        hl = q.shape[2]
        out = LY.cached_attention(q * self._q_scale, ck, cv, qpos,
                                  window=window, softcap=cfg.attn_softcap)
        out = out * head_mask[None, None, :, None]
        o = torch.matmul(out.reshape(B, C, hl * cfg.head_dim),
                         p["attn"]["wo"])
        if cfg.post_norms:
            o = self._norm(o, p["pn1"])
        x = x + o
        o = self._ffn_decode(p["mlp"], self._norm(x, p["ln2"]), dcfg)
        if cfg.post_norms:
            o = self._norm(o, p["pn2"])
        return x + o

    def _cached_forward(self, params, cache, toks, qpos, dcfg, writer=None):
        """Shared decode / chunked-prefill core: embed toks (B,C) at
        positions qpos (B,C), run the stack against the cache (dense, or
        paged through `writer`; updated in place), return (last-position
        logits, cache)."""
        cfg = self.cfg
        if writer is None:
            ib = torch.arange(toks.shape[0], device=toks.device)[:, None]
            writer = functools.partial(self._kv_writer, index=(ib, qpos),
                                       read=lambda a: a, dcfg=dcfg)
        cos, sin = LY.rope_pos(qpos, cfg.head_dim, cfg.rope_theta)
        x = LY.embed_apply(params["embed"], toks, cfg, dcfg,
                           scale=self._embed_scale)
        for i in range(self.n_steps):
            p = tree_map(lambda a: a[i], params["blocks"])
            for (key, window), kv in zip(self._subs,
                                         self._sub_caches(cache)):
                x = self._decode_sub(p[key] if key else p, x,
                                     PG.kv_map(lambda a: a[i], kv), qpos,
                                     cos, sin, dcfg, window, writer)
        return self._final_logits(params, x), cache

    def decode_local(self, params, cache, tok, pos, dcfg: DistConfig):
        """One decode step. tok: (B,) int64; pos: (B,) int64 PER-REQUEST
        positions.  cache: as `prefill_local`'s, updated in place."""
        return self._cached_forward(params, cache, tok[:, None],
                                    pos[:, None], dcfg)

    def paged_step_local(self, params, arena, table, toks, qpos, dcfg,
                         page: int):
        """One paged serving step: decode (C=1) or a prefill chunk (C>1).

        arena: tree of page pools, leaves (n_steps, n_pages+1, page, ...):
        the last pool row is the scratch page that unallocated table
        entries (-1) write to; table: (B, max_pages) int page ids;
        toks/qpos: (B, C).  Returns (last-position logits (B, V) fp32,
        arena), the arena updated in place."""
        n_rows = PG.kv_leaves(arena)[0].shape[1]
        gidx = PG.gather_index(table, page, n_rows)
        writer = functools.partial(
            self._kv_writer, index=PG.scatter_index(table, qpos, page, n_rows),
            read=lambda a: PG.take_tokens(a, gidx, toks.shape[0]), dcfg=dcfg)
        return self._cached_forward(params, arena, toks, qpos, dcfg, writer)
