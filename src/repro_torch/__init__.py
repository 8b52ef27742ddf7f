"""PyTorch/CUDA port of the `repro` serving and training paths.

Mirrors `repro`'s module layout (``repro_torch/models/dense.py`` answers to
``repro/models/dense.py``) and never imports `jax` or `repro`.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; the hand-written
Hopper kernels live in ``csrc/`` and are built at first use on the card.
"""
