"""Glue between model definitions and the serving steps (the
`stacked_keys` contract of `repro.models.runtime`)."""

from __future__ import annotations


def stacked_keys(model) -> dict:
    """Which top-level param groups carry a leading layer-stack dim.

    Part of the model contract: every model declares `stacked_keys`
    explicitly; a model without it gets a pointed error."""
    sk = getattr(model, "stacked_keys", None)
    if sk is None:
        raise TypeError(
            f"{type(model).__name__} does not declare `stacked_keys`; the "
            "model contract requires a property mapping each layer-stacked "
            "param group to its stack length, e.g. {'blocks': n_steps}")
    return dict(sk)
