"""Model registry: arch id -> (ArchConfig, model instance).

Knows the reference's eleven arch ids; the one not ported yet raises a
clear error instead of failing deep inside a model.
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "deepseek_coder_33b", "phi3_medium_14b", "gemma2_27b", "qwen3_1_7b",
    "qwen2_moe_a2_7b", "qwen3_moe_30b_a3b", "xlstm_1_3b",
    "seamless_m4t_large_v2", "zamba2_1_2b", "internvl2_26b",
    "llama3_8b",
)
PORTED = ("llama3_8b", "qwen3_1_7b", "zamba2_1_2b", "qwen3_moe_30b_a3b",
          "qwen2_moe_a2_7b", "deepseek_coder_33b", "phi3_medium_14b",
          "gemma2_27b", "xlstm_1_3b", "seamless_m4t_large_v2")

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def build_model(cfg):
    """The model class of `cfg.family` (the reference's dispatch, over the
    families ported so far)."""
    if cfg.family == "dense":
        from repro_torch.models.dense import DenseLM
        return DenseLM(cfg)
    if cfg.family == "moe":
        from repro_torch.models.moe import MoELM
        return MoELM(cfg)
    if cfg.family == "xlstm":
        from repro_torch.models.xlstm import XLSTMLM
        return XLSTMLM(cfg)
    if cfg.family == "zamba":
        from repro_torch.models.zamba2 import Zamba2LM
        return Zamba2LM(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not yet ported to repro_torch")


def get_arch(arch_id: str, smoke: bool = False):
    """Returns (ArchConfig, model). `smoke` selects the reduced config."""
    arch_id = _ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not yet ported to repro_torch; "
            f"ported: {PORTED}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    return cfg, build_model(cfg)
