"""Encoder-decoder backbone (seamless-m4t-large-v2's T2TT / S2TT path;
port of `repro.models.encdec`).

The speech frontend is a stub, as in the reference: `input_specs` feeds
precomputed frame embeddings (frontend_dim wide) through a linear
projection to the encoder.  Encoder blocks: bidirectional self-attention
with RoPE over the source positions and a plain GELU FFN.  Decoder blocks:
causal self-attention, cross-attention over the encoder memory, a plain
GELU FFN.  A cell's seq_len splits evenly between source frames and target
tokens (S_src = S_tgt = seq_len / 2).

Two layer stacks, `enc_blocks` and `dec_blocks`, each run through
`core/stack.apply_stack` with its own bucket plan.  The encoder memory
rides the decoder stack's CARRY, {"h", "mem"}, not its consts: its
cotangent sums over the decoder layers and flows back to the encoder
through the prefetch stack's hand-written backward.

Serving: `prefill_local` encodes the frames, runs the decoder over the
target prompt and writes the self-attention keys and values (after RoPE)
and the cross-attention keys and values of the memory into the cache
{"self": (k, v), "cross": (k, v)}; `decode_local` advances each row one
token at its own position, attending the self cache up to that position
and the whole cross cache.  The self cache has a capacity of its own (the
reference's is the prompt's length, so its decode past the prompt drops
the write).  Both attentions of a decode step are the reference's einsums
(`layers.cached_attention`, fp32 scores), the prefill's and training's go
through the flash kernels.

Not ported, each raising "not yet ported": the pipeline-stage contract
(`stage_spec`, pp > 1) and tp > 1 (which the port runs for no family).
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.dist import DistConfig
from repro_torch.core.irgraph import BlockStats
from repro_torch.core.meta import ParamMeta, named_leaves, tree_map
from repro_torch.core.remat import maybe_remat
from repro_torch.core.stack import apply_stack
from repro_torch.models import layers as LY
from repro_torch.models.common import ArchConfig, InputSpec, ShapeConfig

XATTN = ("wq", "wk", "wv", "wo")


def _unported(what: str):
    raise NotImplementedError(
        f"encdec {what} is not yet ported to repro_torch (training and "
        "serving at pp=1, tp=1 are)")


class EncDecLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not "
                             "encdec")
        self.cfg = cfg
        self.n_enc = cfg.n_enc_layers or cfg.n_layers
        self.n_dec = cfg.n_dec_layers or cfg.n_layers
        self.n_steps = self.n_enc + self.n_dec

    # ------------------------------------------------------------- metas --
    def _xattn_metas(self, dcfg, dt, prefix):
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.head_dim
        lay = cfg.gqa_layout(dcfg.tp_size)
        hq, kvp = lay["hq"], lay["kvp"]
        kv_tp = 0 if lay["mode"] == "sharded" else None
        return {
            "wq": ParamMeta(prefix + "wq", (d, hq * hd), 1, dt),
            "wk": ParamMeta(prefix + "wk", (kvp * hd, d), kv_tp, dt),
            "wv": ParamMeta(prefix + "wv", (kvp * hd, d), kv_tp, dt),
            "wo": ParamMeta(prefix + "wo", (hq * hd, d), 0, dt),
        }

    def enc_block_metas(self, dcfg: DistConfig) -> dict:
        cfg, dt = self.cfg, dcfg.storage_dtype
        return {
            "ln1": LY.norm_meta("e.ln1", cfg.d_model, dt),
            "attn": LY.attn_metas(cfg, dcfg, dt, prefix="e.attn."),
            "ln2": LY.norm_meta("e.ln2", cfg.d_model, dt),
            "mlp": LY.mlp_metas(cfg, dcfg, dt, prefix="e.mlp."),
        }

    def dec_block_metas(self, dcfg: DistConfig) -> dict:
        cfg, dt = self.cfg, dcfg.storage_dtype
        return {
            "ln1": LY.norm_meta("d.ln1", cfg.d_model, dt),
            "attn": LY.attn_metas(cfg, dcfg, dt, prefix="d.attn."),
            "lnx": LY.norm_meta("d.lnx", cfg.d_model, dt),
            "xattn": self._xattn_metas(dcfg, dt, "d.xattn."),
            "ln2": LY.norm_meta("d.ln2", cfg.d_model, dt),
            "mlp": LY.mlp_metas(cfg, dcfg, dt, prefix="d.mlp."),
        }

    def metas(self, dcfg: DistConfig) -> dict:
        cfg, dt = self.cfg, dcfg.storage_dtype
        return {
            "embed": LY.embed_meta("embed", cfg, dt),
            "front_proj": ParamMeta("front_proj",
                                    (cfg.frontend_dim, cfg.d_model), None,
                                    dt),
            "enc_blocks": self.enc_block_metas(dcfg),
            "dec_blocks": self.dec_block_metas(dcfg),
            "enc_norm": LY.norm_meta("enc_norm", cfg.d_model, dt),
            "final_norm": LY.norm_meta("final_norm", cfg.d_model, dt),
            "head": LY.head_meta("head", cfg, dt),
        }

    @property
    def stacked_keys(self) -> dict:
        return {"enc_blocks": self.n_enc, "dec_blocks": self.n_dec}

    def n_params(self) -> int:
        """Sum of the metas' global sizes, each block once per layer."""
        from repro_torch.models.runtime import n_params
        return n_params(self)

    def stage_spec(self, n_stages: int):
        _unported("stage_spec (pipeline stages)")

    # -------------------------------------------------------------- init --
    def _enc_init(self, generator, dcfg, device, dtype) -> dict:
        cfg = self.cfg
        return {
            "ln1": LY.norm_init(cfg.d_model, device, dtype),
            "attn": LY.attn_init(generator, cfg, dcfg, device, dtype),
            "ln2": LY.norm_init(cfg.d_model, device, dtype),
            "mlp": LY.mlp_init(generator, cfg, device, dtype),
        }

    def _dec_init(self, generator, dcfg, device, dtype) -> dict:
        cfg = self.cfg
        attn = LY.attn_init(generator, cfg, dcfg, device, dtype)
        x = LY.attn_init(generator, cfg, dcfg, device, dtype)
        return {
            "ln1": LY.norm_init(cfg.d_model, device, dtype),
            "attn": attn,
            "lnx": LY.norm_init(cfg.d_model, device, dtype),
            "xattn": {k: x[k] for k in XATTN},
            "ln2": LY.norm_init(cfg.d_model, device, dtype),
            "mlp": LY.mlp_init(generator, cfg, device, dtype),
        }

    def init_full(self, generator: torch.Generator, dcfg: DistConfig,
                  device, dtype: torch.dtype) -> dict:
        """Full params with the reference's distributions, made on `device`
        in `dtype` one layer at a time."""
        cfg = self.cfg

        def stack(metas, n, init):
            out = tree_map(lambda m: torch.empty(
                (n, *m.global_shape), device=device, dtype=dtype), metas)
            for i in range(n):
                tree_map(lambda dst, src: dst[i].copy_(src), out,
                         init(generator, dcfg, device, dtype))
            return out

        return {
            "embed": LY.embed_init(generator, cfg, device, dtype),
            "front_proj": LY._normal((cfg.frontend_dim, cfg.d_model), 0.02,
                                     generator, device, dtype),
            "enc_blocks": stack(self.enc_block_metas(dcfg), self.n_enc,
                                self._enc_init),
            "dec_blocks": stack(self.dec_block_metas(dcfg), self.n_dec,
                                self._dec_init),
            "enc_norm": LY.norm_init(cfg.d_model, device, dtype),
            "final_norm": LY.norm_init(cfg.d_model, device, dtype),
            "head": LY.head_init(generator, cfg, device, dtype),
        }

    # ------------------------------------------------------------ blocks --
    def _rope(self, seq_len: int, device) -> dict:
        cos, sin = LY.rope_cache(seq_len, self.cfg.head_dim,
                                 self.cfg.rope_theta, device)
        return {"rope_cos": cos, "rope_sin": sin}

    def _out(self, out, wo, head_mask):
        """The heads' output (B, S, hl, hd), padded heads zeroed, through
        wo."""
        B, S, hl, hd = out.shape
        out = out * head_mask[None, None, :, None]
        return torch.matmul(out.reshape(B, S, hl * hd), wo)

    def enc_block(self, p, consts, x, dcfg: DistConfig):
        cfg = self.cfg
        h = LY.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v, head_mask = LY._local_qkv(p["attn"], h, cfg, dcfg)
        cos, sin = consts["rope_cos"], consts["rope_sin"]
        q, k = LY.apply_rope(q, cos, sin), LY.apply_rope(k, cos, sin)
        out = LY.attention(q, k, v, causal=False)          # bidirectional
        x = x + self._out(out, p["attn"]["wo"], head_mask)
        h = LY.rmsnorm(x, p["ln2"], cfg.norm_eps)
        return x + LY.mlp_apply(p["mlp"], h, self.cfg, dcfg), {}

    def _cross_kv(self, p, mem, dcfg):
        """Cross-attention keys and values (B, S_src, kvp, hd) of the
        memory (no RoPE)."""
        B, S, _ = mem.shape
        kvp, hd = self.cfg.gqa_layout(dcfg.tp_size)["kvp"], self.cfg.head_dim
        k = torch.matmul(mem, p["wk"].t()).view(B, S, kvp, hd)
        v = torch.matmul(mem, p["wv"].t()).view(B, S, kvp, hd)
        return k, v

    def _cross_q(self, p, x, dcfg):
        """Cross-attention queries (B, S, hq, hd) of x and the head mask.
        The reference projects q, k and v of both x and the memory
        (`_local_qkv` twice) and keeps the half it needs; only that half is
        computed here."""
        B, S, _ = x.shape
        hq = self.cfg.gqa_layout(dcfg.tp_size)["hq"]
        q = torch.matmul(x, p["wq"]).view(B, S, hq, self.cfg.head_dim)
        return q, LY.head_mask(self.cfg, dcfg, x.device, q.dtype)

    def _cross_attn(self, p, x, mem, dcfg):
        """Queries from the decoder's hidden x, keys and values from the
        encoder memory: (B, S_tgt, d), and the memory's (k, v)."""
        q, head_mask = self._cross_q(p, x, dcfg)
        k, v = self._cross_kv(p, mem, dcfg)
        out = LY.attention(q, k, v, causal=False)
        return self._out(out, p["wo"], head_mask), (k, v)

    def _dec_layer(self, p, rope, x, mem, dcfg):
        """One decoder layer: (y, (self k, v), (cross k, v))."""
        cfg = self.cfg
        h = LY.rmsnorm(x, p["ln1"], cfg.norm_eps)
        h, kv = LY.attn_apply(p["attn"], h, rope, cfg, dcfg)
        x = x + h
        h = LY.rmsnorm(x, p["lnx"], cfg.norm_eps)
        h, xkv = self._cross_attn(p["xattn"], h, mem, dcfg)
        x = x + h
        h = LY.rmsnorm(x, p["ln2"], cfg.norm_eps)
        return x + LY.mlp_apply(p["mlp"], h, cfg, dcfg), kv, xkv

    def dec_block(self, p, consts, carry, dcfg: DistConfig):
        mem = carry["mem"]
        x, _, _ = self._dec_layer(p, (consts["rope_cos"], consts["rope_sin"]),
                                  carry["h"], mem, dcfg)
        return {"h": x, "mem": mem}, {}

    # ------------------------------------------------------------- train --
    def _encode(self, front_proj, enc_norm, frames, dcfg, run_stack):
        """frames (B, S_src, frontend_dim) -> the normed memory (B, S_src,
        d) in param_dtype; `run_stack(fn, consts, mem)` runs the encoder
        blocks."""
        mem = torch.matmul(frames.to(dcfg.param_dtype), front_proj)
        mem = run_stack(functools.partial(self.enc_block, dcfg=dcfg),
                        self._rope(frames.shape[1], frames.device), mem)
        return LY.rmsnorm(mem, enc_norm, self.cfg.norm_eps)

    def stage_pre(self, storage, mb, dcfg: DistConfig, plans=None):
        """frames -> the encoder stack -> memory; target tokens -> the
        decoder's input.  Both ride the decoder's carry."""
        cfg, dt = self.cfg, dcfg.storage_dtype
        plans = plans or {}

        def run_stack(fn, consts, mem):
            return apply_stack(fn, self.enc_block_metas(dcfg), dcfg,
                               storage["enc_blocks"], consts, mem,
                               plan=plans.get("enc_blocks"))[0]

        wp = coll.replicate(storage["front_proj"], ParamMeta(
            "front_proj", (cfg.frontend_dim, cfg.d_model), None, dt), dcfg)
        wn = coll.replicate(storage["enc_norm"],
                            LY.norm_meta("enc_norm", cfg.d_model, dt), dcfg)
        mem = self._encode(wp, wn, mb["frames"], dcfg, run_stack)
        emb_meta = LY.embed_meta("embed", cfg, dt)

        def embed_fn(shard, ids):
            table = coll.replicate(shard, emb_meta, dcfg)
            return LY.embed_apply(table, ids, cfg, dcfg)

        x = maybe_remat(embed_fn, "fsdp_only")(storage["embed"],
                                               mb["tokens"])
        return {"h": x, "mem": mem}

    def stage_blocks(self, storage, state, dcfg: DistConfig, plan=None):
        """The decoder stack under the SimpleFSDP schedule with the
        decoder's bucket `plan` (None: resolved as the reference does,
        without stats)."""
        dec = functools.partial(self.dec_block, dcfg=dcfg)
        carry, _ = apply_stack(dec, self.dec_block_metas(dcfg), dcfg,
                               storage["dec_blocks"],
                               self._rope(state["h"].shape[1],
                                          state["h"].device),
                               state, plan=plan)
        return carry

    def stage_loss(self, storage, state, mb, dcfg: DistConfig):
        cfg, dt = self.cfg, dcfg.storage_dtype
        w_fn = coll.replicate(storage["final_norm"],
                              LY.norm_meta("final_norm", cfg.d_model, dt),
                              dcfg)
        x = LY.rmsnorm(state["h"], w_fn, cfg.norm_eps)
        w = coll.replicate(storage["head"], LY.head_meta("head", cfg, dt),
                           dcfg)
        loss, _ = LY.vocab_parallel_xent(LY.logits_f32(x, w, cfg),
                                         mb["targets"], mb["valid"])
        return loss

    def loss_local(self, storage, batch, dcfg: DistConfig, plans=None):
        """batch: frames (B, S_src, frontend_dim) fp32, tokens / targets
        (B, S_tgt) int, valid (B, S_tgt) fp32.  Returns (this rank's masked
        mean loss, {}).  `plans`: {stacked key: its BucketPlan}, the plan
        each stack runs (a missing key: that stack resolves its own)."""
        plans = plans or {}
        state = self.stage_blocks(storage,
                                  self.stage_pre(storage, batch, dcfg, plans),
                                  dcfg, plans.get("dec_blocks"))
        return self.stage_loss(storage, state, batch, dcfg), {}

    # ------------------------------------------------------------- serve --
    def _final_logits(self, params, x):
        """Final norm and fp32 logits of the last position of x (B, S, d)."""
        x = LY.rmsnorm(x[:, -1:].contiguous(), params["final_norm"],
                       self.cfg.norm_eps)
        return LY.logits_f32(x, params["head"], self.cfg)[:, 0]

    def prefill_local(self, params, batch, dcfg: DistConfig, cache):
        """params: full params, blocks stacked; batch: {"frames": (B, S_src,
        frontend_dim), "tokens": (B, p) int64}; cache: `train.serve.
        alloc_cache`'s {"self": (k, v) of (n_dec, B, T, Kh, hd), "cross":
        (k, v) of (n_dec, B, S_src, Kh, hd)} with p <= T, which this call
        fills (the self cache's first p positions, the whole cross cache).

        Returns (last-position logits (B, V) fp32, cache)."""
        cfg = self.cfg
        frames, tokens = batch["frames"], batch["tokens"]
        (sk, sv), (xk, xv) = cache["self"], cache["cross"]
        p = tokens.shape[1]
        if p > sk.shape[2] or frames.shape[:2] != xk.shape[1:3] \
                or tokens.shape[0] != sk.shape[1]:
            raise ValueError(
                f"frames {tuple(frames.shape)} / tokens "
                f"{tuple(tokens.shape)} against a self cache of "
                f"{tuple(sk.shape)} and a cross cache of {tuple(xk.shape)}")

        def run_stack(fn, consts, mem):
            for i in range(self.n_enc):
                mem, _ = fn(tree_map(lambda a: a[i], params["enc_blocks"]),
                            consts, mem)
            return mem

        mem = self._encode(params["front_proj"], params["enc_norm"], frames,
                           dcfg, run_stack)
        rope = LY.rope_cache(p, cfg.head_dim, cfg.rope_theta, tokens.device)
        x = LY.embed_apply(params["embed"], tokens, cfg, dcfg)
        for i in range(self.n_dec):
            lp = tree_map(lambda a: a[i], params["dec_blocks"])
            x, (k, v), (ck, cv) = self._dec_layer(lp, rope, x, mem, dcfg)
            sk[i, :, :p].copy_(k)
            sv[i, :, :p].copy_(v)
            xk[i].copy_(ck)
            xv[i].copy_(cv)
        return self._final_logits(params, x), cache

    def decode_local(self, params, cache, tok, pos, dcfg: DistConfig):
        """One decoder token a row. tok: (B,) int64; pos: (B,) int64
        per-row positions (< the self cache's capacity).  cache: as
        `prefill_local`'s; the self cache takes each row's key and value
        at its position, in place.  Returns (logits (B, V) fp32, cache)."""
        cfg = self.cfg
        B = tok.shape[0]
        qpos = pos[:, None]
        cos, sin = LY.rope_pos(qpos, cfg.head_dim, cfg.rope_theta)
        x = LY.embed_apply(params["embed"], tok[:, None], cfg, dcfg)
        ib = torch.arange(B, device=tok.device)
        (sk, sv), (xk, xv) = cache["self"], cache["cross"]
        # the reference divides q by sqrt(hd) inside its `_cached_attn`
        sqrt_hd = math.sqrt(cfg.head_dim)
        for i in range(self.n_dec):
            p = tree_map(lambda a: a[i], params["dec_blocks"])
            # self-attention over the cache up to each row's position
            h = LY.rmsnorm(x, p["ln1"], cfg.norm_eps)
            q, k, v, hm = LY._local_qkv(p["attn"], h, cfg, dcfg)
            q = LY.apply_rope_pos(q, cos, sin)
            k = LY.apply_rope_pos(k, cos, sin)
            sk[i, ib, pos] = k[:, 0].to(sk.dtype)
            sv[i, ib, pos] = v[:, 0].to(sv.dtype)
            out = LY.cached_attention(q / sqrt_hd, sk[i],
                                      sv[i], qpos)
            x = x + self._out(out, p["attn"]["wo"], hm)
            # cross-attention over the whole cross cache
            h = LY.rmsnorm(x, p["lnx"], cfg.norm_eps)
            q, hm = self._cross_q(p["xattn"], h, dcfg)
            out = LY.cached_attention(q / sqrt_hd, xk[i],
                                      xv[i], None)
            x = x + self._out(out, p["xattn"]["wo"], hm)
            h = LY.rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + LY.mlp_apply(p["mlp"], h, cfg, dcfg)
        return self._final_logits(params, x), cache

    # ----------------------------------------------------------- costing --
    def block_stats(self, dcfg: DistConfig, batch_shape) -> BlockStats:
        """The reference's workload of one DECODER block, per device (2 x
        tokens x numel FLOPs a leaf), at B x S tokens of the cell's whole
        seq_len, as the reference prices it."""
        B, S = batch_shape          # per-device microbatch
        tokens = B * S
        it = dcfg.param_dtype.itemsize
        pf, pb = {}, {}
        for nm, m in named_leaves(self.dec_block_metas(dcfg)):
            pf[nm] = 2.0 * tokens * m.numel_local(dcfg)
            pb[nm] = m.numel_local(dcfg) * it
        return BlockStats(param_flops=pf, param_bytes=pb,
                          act_bytes=tokens * self.cfg.d_model * it
                          / dcfg.tp_size)

    def bucket_units(self) -> list[list[str]]:
        return [["attn/*", "ln1"], ["xattn/*", "lnx"], ["mlp/*", "ln2"]]

    def input_specs(self, shape: ShapeConfig, dcfg: DistConfig) -> dict:
        B = shape.global_batch
        S = shape.seq_len // 2            # split: S_src = S_tgt = seq/2
        frames = InputSpec((B, S, self.cfg.frontend_dim), "float32")
        if shape.kind == "train":
            return {"frames": frames, "tokens": InputSpec((B, S), "int32"),
                    "targets": InputSpec((B, S), "int32"),
                    "valid": InputSpec((B, S), "float32")}
        if shape.kind == "prefill":
            return {"frames": frames, "tokens": InputSpec((B, S), "int32")}
        return {"tok": InputSpec((B,), "int32")}
