"""The bf16 SSD backward's host plan (`kernels/ssd/ops.py`): how many
heads a block of the chunk gradients takes and the fp32 scratch the
backward allocates.  Pure host arithmetic: no kernel, no card."""

import pytest

from repro_torch.kernels.ssd import ops


@pytest.mark.parametrize("H,G,want", [
    (64, 1, 16),   # zamba2-1.2b: four blocks of 16 heads a chunk
    (48, 1, 16), (24, 1, 8), (24, 2, 4), (12, 2, 2), (4, 2, 2), (8, 8, 1),
    (6, 1, 2), (7, 1, 1)])
def test_bwd_heads_is_the_largest_power_of_two_up_to_16_in_a_group(H, G,
                                                                   want):
    assert ops.bwd_heads(H, G) == want


def test_bwd_heads_blocks_never_straddle_a_group():
    for G in (1, 2, 3, 4, 8):
        for per in range(1, 41):
            hb = ops.bwd_heads(per * G, G)
            assert per % hb == 0 and hb & (hb - 1) == 0
            assert hb <= ops.MAX_BWD_HEADS


def test_bwd_buffers_shrink_the_db_dc_partials_by_the_heads_a_block():
    """zamba2-1.2b's layer (B 4, T 2048, H 64, G 1, N 64, chunk 128): one dB
    and one dC partial a block of 16 heads, 8.4 MB each in fp32 (a head
    each, as the fp32 route keeps, would be 134 MB)."""
    bf16 = ops.bwd_buffers(4, 2048, 64, 1, 64, 128, True)
    f32 = ops.bwd_buffers(4, 2048, 64, 1, 64, 128, False)
    assert bf16["dBh"] == bf16["dCh"] == (4, 2048, 4, 64)
    assert f32["dBh"] == f32["dCh"] == (4, 2048, 64, 64)
    assert bf16["dA_part"] == bf16["dD_part"] == f32["dA_part"] == (64, 64)
    assert 4 * 2048 * 4 * 64 * 4 == 8_388_608
    # a ragged last chunk counts as a chunk
    assert ops.bwd_buffers(1, 300, 4, 1, 64, 128, True)["dA_part"] == (4, 3)
