"""Mixture-of-Experts family (qwen2-moe-a2.7b, qwen3-moe-30b-a3b): port of
`repro.models.moe` at tp = 1.

Inherits attention, embedding, loss and serving from `DenseLM` and replaces
the FFN with a router (replicated), capacity-based top-k dispatch into
per-expert buffers, the expert FFNs as batched products, and optionally a
shared expert (a dense SwiGLU of d_ff_shared) with a sigmoid gate
(qwen2-moe).  Expert stacks are (ep, d, fe) leaves sharded on their expert
dim for TP (`tp_dim=0`); under SimpleFSDP they are ZeRO-3 storage like any
other leaf.  The switch-style load-balance loss rides the stack's aux
channel and is added to the cross-entropy loss in `stage_loss`; beside it
rides the count of (token, choice) pairs dropped over capacity, summed
over the layers (`moe_drops`, no gradient).

Every step is deterministic on the card: the dispatch writes each kept
(token, choice) into its own slot (an indexed copy, no atomics), and the
combine and the backward of the token gather are sums over a (T, k, D)
view, where the reference's scatter-adds would be atomics with k writers
a token.  The expert products are cuBLAS batched GEMMs, as the reference
computes them outside any Pallas kernel.  tp > 1 (the EP all_to_all)
raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import ParamMeta
from repro_torch.models import layers as LY
from repro_torch.models.common import ArchConfig
from repro_torch.models.dense import DenseLM


def experts_padded(cfg: ArchConfig, tp: int) -> int:
    """Routed experts padded to a multiple of max(pad_to, tp)."""
    m = max(cfg.pad_to, tp)
    if m % tp:
        raise ValueError(f"pad_to {cfg.pad_to} incompatible with tp={tp}")
    return -(-cfg.n_experts // m) * m


def _counts(flat, ep: int):
    """Choices per expert, (ep,) int64: an integer scatter-add, exact in
    any order, where `torch.bincount` would read the ids' maximum back to
    the host."""
    return torch.zeros(ep, dtype=torch.int64, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))


def capacity(cfg: ArchConfig, tokens: int, ep: int) -> int:
    """Slots per expert: the reference's expression, in Python floats."""
    k = cfg.n_experts_active
    C = max(4, int(-(-tokens * k * cfg.capacity_factor // ep)))
    return -(-C // 4) * 4


class MoELM(DenseLM):
    family = "moe"

    # ------------------------------------------------------------- params --
    def _ffn_metas(self, dcfg, dtype, prefix=""):
        cfg = self.cfg
        d, fe = cfg.d_model, cfg.d_ff_expert
        ep = experts_padded(cfg, dcfg.tp_size)
        m = {
            "router": ParamMeta(prefix + "router", (d, ep), None, dtype),
            "we_g": ParamMeta(prefix + "we_g", (ep, d, fe), 0, dtype),
            "we_u": ParamMeta(prefix + "we_u", (ep, d, fe), 0, dtype),
            "we_d": ParamMeta(prefix + "we_d", (ep, fe, d), 0, dtype),
        }
        if cfg.d_ff_shared:
            m.update(LY.mlp_metas(cfg, dcfg, dtype, prefix + "shared.",
                                  d_ff=cfg.d_ff_shared))
            m["shared_gate"] = ParamMeta(prefix + "shared_gate", (d, 1),
                                         None, dtype)
        return m

    def _ffn_init(self, generator, dcfg, device, dtype):
        cfg = self.cfg
        d, fe = cfg.d_model, cfg.d_ff_expert
        ep = experts_padded(cfg, dcfg.tp_size)
        sd = 0.02

        def normal(shape, std):
            return LY._normal(shape, std, generator, device, dtype)

        p = {
            "router": normal((d, ep), sd),
            "we_g": normal((ep, d, fe), sd),
            "we_u": normal((ep, d, fe), sd),
            "we_d": normal((ep, fe, d), sd * 0.5),
        }
        if cfg.d_ff_shared:
            p.update(LY.mlp_init(generator, cfg, device, dtype,
                                 d_ff=cfg.d_ff_shared))
            p["shared_gate"] = torch.zeros((d, 1), device=device,
                                           dtype=dtype)
        return p

    # ----------------------------------------------------------- dispatch --
    def _route(self, x2d, router):
        """x2d: (T, D) -> top-k weights (T, k) in x's dtype, expert ids
        (T, k) and the load-balance aux (an fp32 scalar).

        Logits accumulate in fp32; padded experts are masked at -1e30.  The
        top k are taken by a stable sort, so equal probabilities rank by
        expert index, lowest first, as `lax.top_k` ranks them."""
        cfg = self.cfg
        ep = router.shape[1]
        logits = LY.matmul_f32(x2d, router)
        if ep > cfg.n_experts:
            pad = torch.arange(ep, device=x2d.device) >= cfg.n_experts
            logits = logits.masked_fill(pad, -1e30)
        probs = torch.softmax(logits, dim=-1)
        k = cfg.n_experts_active
        ids = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]
        w = probs.gather(1, ids)
        if cfg.moe_norm_topk:
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        # switch-style load balance on the real experts
        T = x2d.shape[0]
        occupancy = _counts(ids.reshape(-1), ep).float() / (T * k)
        aux = cfg.n_experts * torch.sum(occupancy * probs.mean(0))
        return w.to(x2d.dtype), ids, aux

    def _dispatch(self, ids, C: int, ep: int):
        """Slots of the (T*k,) flattened choices: pos (the choice's rank
        among its expert's choices, in token order), keep (pos < C) and
        slot (expert * C + pos where kept, ep * C where dropped).

        The reference ranks by a cumsum over a (T*k, ep) one-hot; here a
        stable sort groups the choices by expert in token order, and a
        choice's rank is its place in the sorted order less its expert's
        first place: the same integers, without the one-hot, whose
        column-wise scan is slow on the card."""
        flat = ids.reshape(-1)
        experts, order = torch.sort(flat, stable=True)
        counts = _counts(flat, ep)
        first = torch.cumsum(counts, 0) - counts
        rank = torch.arange(flat.numel(), device=flat.device) - first[experts]
        pos = torch.empty_like(flat).scatter_(0, order, rank)
        keep = pos < C
        slot = torch.where(keep, flat * C + pos, ep * C)
        return pos, keep, slot

    def _moe_ffn(self, p, x2d, dcfg: DistConfig):
        """Capacity-based dispatch of the local tokens x2d (T, D) ->
        (combined expert outputs (T, D), aux, the number of (token, choice)
        pairs dropped over capacity)."""
        if dcfg.tp_size > 1:
            raise NotImplementedError(
                f"tp={dcfg.tp_size}: the expert-parallel all_to_all is not "
                "yet ported to repro_torch (it comes with tensor "
                "parallelism)")
        cfg = self.cfg
        ep = p["router"].shape[1]
        w, ids, aux = self._route(x2d, p["router"])
        T, D = x2d.shape
        k = cfg.n_experts_active
        C = capacity(cfg, T, ep)
        _, keep, slot = self._dispatch(ids, C, ep)
        # one writer a kept slot; dropped choices land in a spare last row
        xk = x2d[:, None, :].expand(T, k, D).reshape(T * k, D)
        buf = x2d.new_zeros((ep * C + 1, D)).index_put((slot,), xk)
        buf = buf[:-1].view(ep, C, D)
        g = torch.bmm(buf, p["we_g"])
        u = torch.bmm(buf, p["we_u"])
        out = torch.bmm(F.silu(g) * u, p["we_d"]).view(ep * C, D)
        gathered = out.index_select(0, torch.clamp(slot, max=ep * C - 1))
        gathered = gathered * keep[:, None].to(out.dtype)
        combined = (gathered * w.reshape(-1, 1)).view(T, k, D).sum(1)
        return combined, aux, (~keep).sum()

    def _ffn_apply(self, p, x, dcfg):
        cfg = self.cfg
        B, S, D = x.shape
        out, aux, drops = self._moe_ffn(p, x.reshape(B * S, D), dcfg)
        out = out.view(B, S, D)
        if cfg.d_ff_shared:
            sh = LY.mlp_apply({k: p[k] for k in ("wg", "wu", "wd")}, x, cfg,
                              dcfg)
            gate = torch.sigmoid(torch.matmul(x, p["shared_gate"]))
            out = out + sh * gate
        # /tp: the reference's sum-over-TP-ranks gradient convention.
        # moe_drops rides beside it (no gradient): the stack sums it over
        # the layers and the train step logs it
        return out, {"moe_aux": aux * cfg.router_aux_coef / dcfg.tp_size,
                     "moe_drops": drops.float()}

    # ------------------------------------------------------------- train --
    def _aux0(self) -> dict:
        return {"moe_aux": 0.0, "moe_drops": 0.0}

    def _loss_aux(self, aux):
        return aux["moe_aux"]

    def bucket_units(self) -> list[list[str]]:
        """Manual-wrapping module lists (`bucketing.manual_plan`): attention,
        the router and shared expert, the routed experts."""
        return [["attn/*", "ln1"],
                ["mlp/router", "mlp/shared*", "mlp/wg", "mlp/wu", "mlp/wd",
                 "ln2"],
                ["mlp/we_*"]]
