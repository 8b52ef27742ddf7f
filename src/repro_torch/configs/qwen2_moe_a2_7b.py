"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H (GQA kv=16) ff_expert=1408
v=151936, 60 routed top-4 + 4 shared experts [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].
TP16/EP16 note: 60 experts pad to 64 (padded experts masked in routing);
shared experts fused into one TP MLP of d_ff 4*1408=5632."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=5632, vocab=151_936, head_dim=128,
    n_experts=60, n_experts_active=4, n_shared_experts=4,
    d_ff_expert=1408, d_ff_shared=5632, moe_norm_topk=False,
)

SMOKE = ArchConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
    n_experts=6, n_experts_active=2, n_shared_experts=1,
    d_ff_expert=32, d_ff_shared=128, moe_norm_topk=False, capacity_factor=8.0, router_aux_coef=0.0,
    pad_to=4,
)
