"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) ff_expert=768
v=151936, 128 routed top-8, qk_norm, norm_topk [hf:Qwen/Qwen3-30B-A3B; hf].
EP16: 128/16 = 8 experts per rank; kv (4 < 16) TP-replicated."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=768, vocab=151_936, head_dim=128,
    rope_theta=1_000_000.0, qk_norm=True,
    n_experts=128, n_experts_active=8, d_ff_expert=768, moe_norm_topk=True,
)

SMOKE = ArchConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=64, vocab=256, head_dim=16, qk_norm=True,
    n_experts=8, n_experts_active=2, d_ff_expert=32, moe_norm_topk=True, capacity_factor=8.0, router_aux_coef=0.0,
    pad_to=4,
)
