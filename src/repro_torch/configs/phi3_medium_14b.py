"""phi3-medium-14b [dense]: 40L d=5120 40H (GQA kv=10) ff=17920 v=100352.
RoPE SwiGLU GQA [arXiv:2404.14219; unverified]. TP16: 40 q heads pad to 48
(masked); kv (10) TP-replicated."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100_352, head_dim=128,
)

SMOKE = ArchConfig(
    name="phi3-medium-14b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=5, n_kv_heads=5, d_ff=128, vocab=320, head_dim=16,
    pad_to=4,
)
