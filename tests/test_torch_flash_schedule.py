"""The flash backward's dQ schedule (`ops.bwd_schedule`): for each query
tile (64 rows; the fp32 kernel's 16 at hd 128, 32 at hd 64), the 128-key
blocks whose partials the kernel adds into its sum, in the order it adds
them.  Held against a brute-force reading of the plain version's mask: a
block adds into a tile exactly where one of its keys (< T) is visible from
one of the tile's rows (< S), highest block first, with no turn left out
or taken twice.  The card tests hold the kernels' counters against the
same schedule."""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref

torch.set_num_threads(1)


def _brute_force(S, T, causal, window, rows):
    z = torch.zeros(1, max(S, T), 1, 16)
    _, _, mask, _ = ref._scores(z[:, :S], z[:, :T], causal, window, None,
                                None)
    keys = ops.BWD_KEYS
    return [tuple(n for n in reversed(range(-(-T // keys)))
                  if mask[m * rows:(m + 1) * rows,
                          n * keys:(n + 1) * keys].any())
            for m in range(-(-S // rows))]


@pytest.mark.parametrize("S,T,causal,window", [
    (127, 127, True, None),
    (128, 128, True, None),
    (129, 129, True, None),
    (129, 128, False, None),
    (300, 129, True, None),
    (129, 300, True, None),
    (600, 600, True, 127),
    (600, 600, True, 128),
    (600, 600, True, 129),
    (600, 600, False, 127),
    (600, 600, False, 128),
    (600, 600, False, 129),
    (300, 127, True, 129),
    (127, 600, False, 128),
    (2048, 2048, True, None),
    (1500, 1100, True, 300),
])
def test_bwd_schedule_matches_the_mask(S, T, causal, window):
    want = _brute_force(S, T, causal, window, ops.BWD_ROWS)
    got = ops.bwd_schedule(S, T, causal, window)
    assert got == want


# the fp32 kernel's tiles: 16 rows at hd 128, 32 at hd 64
@pytest.mark.parametrize("S,T,causal,window,hd", [
    (127, 127, True, None, 128),
    (129, 300, True, None, 64),
    (600, 600, True, 129, 128),
    (300, 150, False, None, 64),
])
def test_bwd_schedule_matches_the_mask_at_the_fp32_tiles(S, T, causal, window,
                                                         hd):
    rows = ops.bwd_rows(torch.float32, hd)
    assert rows == {128: 16, 64: 32}[hd]
    want = _brute_force(S, T, causal, window, rows)
    got = ops.bwd_schedule(S, T, causal, window, rows)
    assert got == want
