"""xlstm-1.3b [ssm]: 48L d=2048 4H ff=0 v=50304, sLSTM + mLSTM blocks 7:1
(arXiv:2405.04517), as `repro.configs.xlstm_1_3b`.  O(1)-state decode.
Simplifications kept from the reference: full-matrix q/k/v projections (not
block-diagonal-4); see models/xlstm.py."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="xlstm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50_304, head_dim=512,
    ssm_expand=2, ssm_conv=4, ssm_chunk=128, slstm_every=8,
)

SMOKE = ArchConfig(
    name="xlstm-1.3b-smoke", family="xlstm", n_layers=4, d_model=64,
    n_heads=2, n_kv_heads=2, d_ff=0, vocab=256, head_dim=32,
    ssm_expand=2, ssm_conv=4, ssm_chunk=16, slstm_every=4,
    pad_to=4,
)
