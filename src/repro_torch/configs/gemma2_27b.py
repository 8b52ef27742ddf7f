"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) ff=36864 v=256000.
Local(4096)+global alternating, attn softcap 50 / final softcap 30, GeGLU,
sandwich norms, tied embeddings [arXiv:2408.00118; hf].
The reference's config (`repro/configs/gemma2_27b.py`), field for field
but `skip_shapes`, which no code of the port reads."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense", n_layers=46, d_model=4608,
    n_heads=32, n_kv_heads=16, d_ff=36864, vocab=256_000, head_dim=128,
    attn_softcap=50.0, final_softcap=30.0, sliding_window=4096,
    local_global_alternate=True, post_norms=True, gated_mlp="geglu",
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="gemma2-27b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=192, vocab=256, head_dim=16,
    attn_softcap=50.0, final_softcap=30.0, sliding_window=8,
    local_global_alternate=True, post_norms=True, gated_mlp="geglu",
    tie_embeddings=True,
    pad_to=4,
)
