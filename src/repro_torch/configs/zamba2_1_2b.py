"""zamba2-1.2b [hybrid]: 38L d=2048 (Mamba2 d_state=64, 64 ssm heads x 64) +
weight-tied shared attention block (32H x 128 on concat(h, emb) = 4096 wide,
GQA kv=32, ff=8192) invoked every 6 mamba layers [arXiv:2411.15242; hf].
The reference's config (`repro/configs/zamba2_1_2b.py`), field for field;
simplifications in models/zamba2.py."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="zamba", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32_000, head_dim=128,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
    shared_attn_every=6,
)

SMOKE = ArchConfig(
    name="zamba2-1.2b-smoke", family="zamba", n_layers=8, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=32,
    ssm_state=8, ssm_head_dim=16, ssm_expand=2, ssm_conv=4, ssm_chunk=16,
    shared_attn_every=3,
    pad_to=4,
)
