"""VLM family (internvl2-26b): port of `repro.models.vlm`.

The InternViT frontend is a stub, as in the reference: `input_specs` feeds
precomputed ViT patch embeddings (B, n_img_tokens, vit_dim).  The trainable
pieces are the two-layer MLP projector (vit_dim -> d_model -> d_model,
tanh-approximated GELU between) and the dense backbone (`DenseLM`:
llama-style blocks, GQA).  The projected image embeddings take the first
n_img_tokens positions of the sequence, the text the rest; RoPE runs over
the whole sequence, and the loss is masked to the text positions.

Serving: `prefill_local` projects the images, embeds the text prompt and
runs the backbone's prefill over both, so the cache holds the image
positions first; `decode_local` is the backbone's, and a text token p of
the prompt sits at position n_img_tokens + p (the reference's launcher
decodes at p, which ignores the image prefix).

Not ported, each raising: the pipeline-stage contract (`stage_spec`,
pp > 1), tp > 1 (which the port runs for no family), and the paged step
and the serving plan (`paged_kv` is False: the batcher takes token prompts
only, so it cannot carry an image prefix).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as coll
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import ParamMeta
from repro_torch.core.remat import maybe_remat
from repro_torch.models import layers as LY
from repro_torch.models.common import ArchConfig, InputSpec, ShapeConfig
from repro_torch.models.dense import DenseLM


class VLM(DenseLM):
    family = "vlm"
    # the image-prefix / text-span layout is positional: a zigzag
    # sequence permutation would interleave the two, so the family opts
    # out of context parallelism, as the reference's does
    cp_supported = False
    paged_kv = False

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        if not (cfg.vit_dim and cfg.n_img_tokens):
            raise ValueError(f"{cfg.name}: a vlm config needs vit_dim and "
                             "n_img_tokens")

    def stage_spec(self, n_stages: int):
        raise NotImplementedError(
            "vlm stage_spec (pipeline stages) is not yet ported to "
            "repro_torch (training and serving at pp=1, tp=1 are)")

    # ------------------------------------------------------------- metas --
    def _proj_metas(self, dcfg: DistConfig):
        cfg, dt = self.cfg, dcfg.storage_dtype
        return (ParamMeta("proj_w1", (cfg.vit_dim, cfg.d_model), 1, dt),
                ParamMeta("proj_w2", (cfg.d_model, cfg.d_model), None, dt))

    def metas(self, dcfg: DistConfig) -> dict:
        m = super().metas(dcfg)
        m["proj_w1"], m["proj_w2"] = self._proj_metas(dcfg)
        return m

    def init_full(self, generator: torch.Generator, dcfg: DistConfig,
                  device, dtype: torch.dtype) -> dict:
        p = super().init_full(generator, dcfg, device, dtype)
        for m in self._proj_metas(dcfg):
            p[m.name] = torch.empty(m.global_shape, device=device,
                                    dtype=dtype).normal_(
                0.0, 0.02, generator=generator)
        return p

    def input_specs(self, shape: ShapeConfig, dcfg: DistConfig) -> dict:
        """A cell's seq_len counts the image positions: the text spans
        seq_len - n_img_tokens."""
        cfg = self.cfg
        B = shape.global_batch
        ids = InputSpec((B, shape.seq_len - cfg.n_img_tokens), "int32")
        img = InputSpec((B, cfg.n_img_tokens, cfg.vit_dim), "float32")
        if shape.kind == "train":
            return {"tokens": ids, "targets": ids, "img_embeds": img,
                    "valid": InputSpec(ids.shape, "float32")}
        if shape.kind == "prefill":
            return {"tokens": ids, "img_embeds": img}
        return {"tok": InputSpec((B,), "int32")}

    # --------------------------------------------------------- projector --
    @staticmethod
    def _project(img, w1, w2, dcfg: DistConfig):
        """(B, n, vit_dim) -> (B, n, d): the images cast to param_dtype,
        w1, tanh GELU, w2 (the reference's TP all-gather of the hidden
        between them is the identity at tp = 1)."""
        h = F.gelu(torch.matmul(img.to(dcfg.param_dtype), w1),
                   approximate="tanh")
        return torch.matmul(h, w2)

    # ------------------------------------------------------------- train --
    def stage_pre(self, storage, mb, dcfg: DistConfig):
        """The projected images, cast to the text embedding's dtype, then
        the embedded text (its gather under fsdp_only remat, whatever the
        policy, as the reference's)."""
        cfg = self.cfg
        m1, m2 = self._proj_metas(dcfg)
        img_x = self._project(mb["img_embeds"],
                              coll.replicate(storage["proj_w1"], m1, dcfg),
                              coll.replicate(storage["proj_w2"], m2, dcfg),
                              dcfg)
        emb_meta = LY.embed_meta("embed", cfg, dcfg.storage_dtype)

        def embed_fn(shard, ids):
            table = coll.replicate(shard, emb_meta, dcfg)
            return LY.embed_apply(table, ids, cfg, dcfg)

        txt_x = maybe_remat(embed_fn, "fsdp_only")(storage["embed"],
                                                   mb["tokens"])
        return torch.cat([img_x.to(txt_x.dtype), txt_x], 1), self._aux0()

    def stage_loss(self, storage, state, mb, dcfg: DistConfig):
        """The image positions padded with target 0 and valid 0, so they
        leave the masked mean."""
        pad = (self.cfg.n_img_tokens, 0)
        return super().stage_loss(storage, state, dict(
            targets=F.pad(mb["targets"], pad), valid=F.pad(mb["valid"], pad)),
            dcfg)

    # ------------------------------------------------------------- serve --
    def prefill_local(self, params, batch, dcfg: DistConfig, cache):
        """batch: {"tokens": (B, S_text), "img_embeds": (B, n_img,
        vit_dim)}; the backbone's prefill over the image positions, then
        the text, into the first n_img + S_text positions of the cache.
        Returns (last-position logits (B, V) fp32, cache)."""
        img_x = self._project(batch["img_embeds"], params["proj_w1"],
                              params["proj_w2"], dcfg)
        txt_x = LY.embed_apply(params["embed"], batch["tokens"], self.cfg,
                               dcfg)
        x = torch.cat([img_x.to(txt_x.dtype), txt_x], 1)
        return self._prefill_from(params, x, dcfg, cache)
