"""Architecture config schema (the dense, moe, zamba, xlstm, encdec and
vlm subsets of `repro.models.common`).

`ArchConfig` keeps the reference's field names, defaults and derived head
layout (`gqa_layout`) so that parameter shapes line up exactly with the
reference's on every arch, padded or not.  `ShapeConfig` describes one
(seq_len, global_batch, kind) cell.  `BlockSegments` is the segmented
block contract: one block as an ordered chain of segments, each owning the
params its globs name (`core/stack.py` gathers each segment's buckets
inside that segment's remat wrap).
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # 'train' | 'prefill' | 'decode'


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Shape and numpy dtype name of one batch field (`input_specs`)."""
    shape: tuple[int, ...]
    dtype: str


@dataclasses.dataclass(frozen=True)
class BlockSegments:
    """Ordered segment chain of ONE block: state_0 = x -> fns[0] -> ... ->
    fns[S-1] -> (y, aux).

      * ``names``       — segment labels, execution order (attn, mlp);
      * ``param_globs`` — per-segment fnmatch globs over the block's param
        names; each param belongs to the FIRST segment whose globs match;
      * ``fns``         — fns[s](params, consts, state) -> state, where
        `params` holds only segment s's gathered tensors.
    """

    names: tuple[str, ...]
    param_globs: tuple[tuple[str, ...], ...]
    fns: tuple[Callable, ...]

    def __post_init__(self):
        if not (len(self.names) == len(self.param_globs) == len(self.fns)):
            raise ValueError("BlockSegments fields must be parallel, got "
                             f"{len(self.names)}/{len(self.param_globs)}/"
                             f"{len(self.fns)}")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # 'dense' | 'moe' | 'zamba' | 'xlstm' | 'encdec'
    #                           | 'vlm'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    # dense variants ---------------------------------------------------------
    qk_norm: bool = False                 # qwen3
    attn_softcap: float | None = None     # gemma2: 50.0
    final_softcap: float | None = None    # gemma2: 30.0
    sliding_window: int | None = None     # gemma2 local layers: 4096
    local_global_alternate: bool = False  # gemma2
    post_norms: bool = False              # gemma2 sandwich norms
    gated_mlp: str = "swiglu"             # swiglu | geglu | gelu
    tie_embeddings: bool = False

    # moe --------------------------------------------------------------------
    n_experts: int = 0
    n_experts_active: int = 0             # top-k
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0
    router_aux_coef: float = 1e-2
    capacity_factor: float = 1.25
    moe_norm_topk: bool = False           # qwen3-moe renormalizes top-k

    # ssm / hybrid -----------------------------------------------------------
    ssm_state: int = 0                    # mamba2 d_state
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    shared_attn_every: int = 0            # zamba2: shared block period
    slstm_every: int = 0                  # xlstm: 1 sLSTM per N blocks

    # enc-dec ----------------------------------------------------------------
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    frontend_dim: int = 0                 # stub frontend embedding width

    # vlm --------------------------------------------------------------------
    vit_dim: int = 0                      # stub ViT output width
    n_img_tokens: int = 0

    # recommended pipeline-parallel degree on the production mesh (the
    # reference's launch.mesh reads it); 1 = no pipelining.  Nothing in the
    # port reads it before pipeline parallelism is ported
    pp_stages: int = 1

    # head/expert counts pad to a multiple of this (>= any runtime tp that
    # divides it), keeping GLOBAL param shapes mesh-independent.
    pad_to: int = 16

    # ------------------------------------------------------------- derived --
    def gqa_layout(self, tp: int) -> dict:
        """TP attention layout, mesh-independent for every tp dividing
        max(pad_to, tp).

        'sharded':  kv heads split over the TP axis (no padding needed).
        'grouped':  kv TP-replicated; q heads padded so each rank's q heads
                    map to a CONTIGUOUS slice of kv heads.

        Returns {mode, hq (padded q heads), kvp (padded kv heads),
                 g (padded group size), g_real (logical group size)}.
        """
        m = max(self.pad_to, tp)
        if m % tp:
            raise ValueError(f"pad_to {self.pad_to} incompatible with tp={tp}")
        g_real = -(-self.n_heads // self.n_kv_heads)
        if (self.n_kv_heads % m == 0 and self.n_heads % m == 0
                and self.n_heads % self.n_kv_heads == 0):
            return dict(mode="sharded", hq=self.n_heads,
                        kvp=self.n_kv_heads, g=g_real, g_real=g_real)
        if self.n_kv_heads >= m:
            kvp = -(-self.n_kv_heads // m) * m
            g = g_real
        else:
            kvp = next(d for d in range(self.n_kv_heads, m + 1)
                       if m % d == 0)
            step = m // kvp
            g = -(-g_real // step) * step
        return dict(mode="grouped", hq=kvp * g, kvp=kvp, g=g, g_real=g_real)

    def q_heads_padded(self, tp: int) -> int:
        return self.gqa_layout(tp)["hq"]

    def n_params(self) -> int:
        """Parameter count: the sum of the model's metas' global sizes
        (padded heads and experts included).  The reference's formula
        (`repro/models/common.py` `n_params`) counts two norms a layer and
        no final norm, so it leaves out gemma2's post norms; it applies the
        dense formula to zamba and xlstm, which counts attention and MLP
        weights that their layers do not have and misses xlstm's q/k/v
        projections (d_inner x d_inner each); and for moe it counts the real
        experts, not the padded ones the metas hold, and leaves out the q/k
        norms and the shared expert's gate."""
        from repro_torch.models.registry import build_model
        from repro_torch.models.runtime import n_params
        return n_params(build_model(self))

    def n_params_active(self) -> int:
        """Parameters applied to each token: `n_params` less, for moe, the
        routed experts a token does not visit (all but top-k of the padded
        expert stack)."""
        if self.family != "moe":
            return self.n_params()
        from repro_torch.models.moe import experts_padded
        idle = experts_padded(self, 1) - self.n_experts_active
        return self.n_params() - self.n_layers * idle * 3 * self.d_model \
            * self.d_ff_expert
