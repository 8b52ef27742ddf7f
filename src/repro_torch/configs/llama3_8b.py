"""llama3-8b [dense]: the paper's own eval model (Table 2 row 1):
32L d=4096 32H (GQA kv=8) ff=14336 v=128256."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128_256, head_dim=128,
    rope_theta=500_000.0,
)

SMOKE = ArchConfig(
    name="llama3-8b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    pad_to=4,
)
