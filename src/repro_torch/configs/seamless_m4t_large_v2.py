"""seamless-m4t-large-v2 [audio]: enc-dec transformer backbone, 24 enc + 24
dec layers, d=1024 16H (kv=16) ff=8192 v=256206, plain GELU FFN
[arXiv:2308.11596], as `repro.configs.seamless_m4t_large_v2`.  The speech
frontend is a stub: `input_specs` feeds precomputed 1024-d frame
embeddings.  A cell's seq_len splits S_src = S_tgt = seq/2.  Every field
but `skip_shapes`, which no code of the port reads."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=48,
    n_enc_layers=24, n_dec_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=16, d_ff=8192, vocab=256_208, head_dim=64,  # vocab padded 256206->256208 (tp16)
    gated_mlp="gelu", frontend_dim=1024,
)

SMOKE = ArchConfig(
    name="seamless-m4t-large-v2-smoke", family="encdec", n_layers=4,
    n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16, gated_mlp="gelu", frontend_dim=32,
    pad_to=4,
)
