"""deepseek-coder-33b [dense]: 62L d=7168 56H (GQA kv=8) ff=19200 v=32256.
llama-arch [arXiv:2401.14196; hf]. TP16 note: 56 q heads pad to 64 (masked);
kv (8 < 16) TP-replicated + per-rank group slice (DESIGN.md)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense", n_layers=62, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=19200, vocab=32256, head_dim=128,
    rope_theta=100_000.0,
    # 62 layers only split evenly 2 ways; (pipe, data, model) = (2, 8, 16)
    # with 31 layers per stage, 1F1B (the reference's launch.mesh).
    pp_stages=2,
)

SMOKE = ArchConfig(
    name="deepseek-coder-33b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=6, n_kv_heads=2, d_ff=160, vocab=256, head_dim=16,
    rope_theta=100_000.0,
    pad_to=4,
)
