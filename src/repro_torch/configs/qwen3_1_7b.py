"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) ff=6144 v=151936.
qk_norm, GQA, tied embeddings."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=6144, vocab=151_936, head_dim=128,
    rope_theta=1_000_000.0, qk_norm=True, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="qwen3-1.7b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    qk_norm=True, tie_embeddings=True,
    pad_to=4,
)
