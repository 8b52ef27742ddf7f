"""qwen3-1.7b [dense]: the shape of the published Qwen/Qwen3-1.7B
`config.json` (Hugging Face): 28 layers, hidden 2048, 16 attention heads,
8 KV heads, head_dim 128, intermediate 6144, vocab 151936, rope_theta 1e6,
tie_word_embeddings true; qk-norm on every layer."""
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
