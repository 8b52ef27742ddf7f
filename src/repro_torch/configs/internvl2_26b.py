"""internvl2-26b [vlm]: InternViT (a stub frontend: precomputed 3200-d
patch embeddings, 1025 of them) + the InternLM2 backbone, 48 layers, d 6144,
48 q heads on 8 kv heads, d_ff 16384, vocab 92553 padded to 92560
[arXiv:2404.16821], as `repro.configs.internvl2_26b`.  A cell's seq_len
counts the image positions: S_text = seq_len - n_img_tokens.  Every field
but `skip_shapes`, which no code of the port reads."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92_560, head_dim=128,  # vocab padded 92553->92560 (tp16)
    vit_dim=3200, n_img_tokens=1025,
)

SMOKE = ArchConfig(
    name="internvl2-26b-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    vit_dim=48, n_img_tokens=8,
    pad_to=4,
)
