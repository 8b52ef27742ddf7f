"""Activation-checkpoint policies: the paper's selective-AC FSDP trick
(port of `repro.core.remat`).

Paper Fig. 1(1): the SAC policy marks exactly the FSDP all-gathers as
must-recompute, so gathered parameters are dropped after their forward use
and gathered again before their backward use.  In the port:

  * ``"none"``      — no remat; autograd keeps the gathered parameters it
    saves (the paper's "no AC" row, which is why SimpleFSDP-noAC uses more
    memory than FSDP2);
  * ``"fsdp_only"`` — saved-tensor hooks (`collectives.regather_scope`)
    store every saved tensor that lies in a gathered bucket as a handle,
    and the backward re-gathers the bucket once; everything else autograd
    saves is kept;
  * ``"full"``      — `torch.utils.checkpoint` (non-reentrant): the block's
    input only, the whole block (gathers included) recomputed;
  * ``"save_dots"`` — `torch.utils.checkpoint` with a selective policy that
    keeps matrix-product outputs and recomputes the rest (gathers
    included), the closest torch form of the reference's
    ``checkpoint_dots_with_no_batch_dims``.

``parse_remat`` validates a spec once.  ``"auto:<GB>"`` is the budgeted
form: `core/memory` picks the cheapest per-segment policy vector whose
modeled peak fits the per-device budget, and `core/api.plan_parallel`
writes it back as a comma-joined per-segment vector
("attn=full,mlp=fsdp_only"), which users may also set directly.

On the prefetch path (`reorder=True`, `core/stack.py`) the hand-written
backward already saves only each layer's input and re-gathers per bucket,
so ``none`` and ``fsdp_only`` change nothing there; ``full`` and
``save_dots`` checkpoint a segment inside the backward's recompute, which
bounds how much of it is resident at once (the values are the same).
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import collectives as coll

POLICIES = ("none", "fsdp_only", "full", "save_dots")
_AGGRESSIVENESS = ("none", "fsdp_only", "save_dots", "full")
AUTO_PREFIX = "auto"
VECTOR_KIND = "vector"

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def parse_remat(spec) -> tuple[str, float | None]:
    """Validate a remat spec -> (kind, budget_bytes).

    `kind` is one of POLICIES, ``"auto"`` or ``"vector"``; `budget_bytes`
    is the parsed HBM budget of the auto form (None otherwise).  Raises a
    pointed ValueError for malformed strings: ``auto`` / ``auto:`` without
    a budget, a non-numeric or non-positive budget, an unknown policy."""
    if not isinstance(spec, str):
        raise ValueError(
            f"remat must be a string, got {type(spec).__name__}; one of "
            f"{POLICIES} or 'auto:<GB>' (e.g. 'auto:12.5')")
    if "," in spec or "=" in spec:
        parse_policy_vector(spec)
        return VECTOR_KIND, None
    if spec == AUTO_PREFIX or spec.startswith(AUTO_PREFIX + ":"):
        body = spec[len(AUTO_PREFIX):]
        if not body or body == ":":
            raise ValueError(
                f"remat={spec!r}: the auto form needs an HBM budget in GiB "
                "after the colon, e.g. remat='auto:12.5'")
        try:
            gb = float(body[1:])
        except ValueError:
            raise ValueError(
                f"remat={spec!r}: budget {body[1:]!r} is not a number; "
                "expected remat='auto:<GB>' with a positive GiB value") \
                from None
        # NaN fails every comparison, so `gb <= 0` alone would let it pass
        if not math.isfinite(gb) or gb <= 0:
            raise ValueError(
                f"remat={spec!r}: budget must be a finite GiB value > 0")
        return AUTO_PREFIX, gb * 1024**3
    if spec not in POLICIES:
        raise ValueError(
            f"unknown remat policy {spec!r}; one of {POLICIES} or "
            "'auto:<GB>'")
    return spec, None


def parse_policy_vector(spec: str) -> tuple[tuple[str | None, str], ...]:
    """"full,fsdp_only" (positional) or "attn=full,mlp=fsdp_only" (named)
    -> ((seg_name | None, policy), ...)."""
    entries = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            raise ValueError(
                f"remat={spec!r}: empty entry in the per-segment vector")
        name, _, pol = part.rpartition("=")
        if pol not in POLICIES:
            raise ValueError(
                f"remat={spec!r}: unknown policy {pol!r} in the per-segment "
                f"vector; each entry must be one of {POLICIES}")
        entries.append((name or None, pol))
    named = [n is not None for n, _ in entries]
    if any(named) and not all(named):
        raise ValueError(
            f"remat={spec!r}: mix of named (seg=policy) and positional "
            "entries; use one form")
    return tuple(entries)


def resolve_segment_policies(spec: str, seg_names) -> tuple[str, ...]:
    """One concrete policy per block segment: a uniform spec broadcasts; a
    vector must match the segment count (positional) or name every segment
    exactly once."""
    seg_names = tuple(seg_names)
    kind, _ = parse_remat(spec)
    if kind == AUTO_PREFIX:
        raise ValueError(
            f"remat={spec!r} reached the runtime unresolved; the budgeted "
            "auto form is resolved to a per-segment vector by "
            "core/api.plan_parallel — go through parallelize() or set an "
            "explicit policy (vector)")
    if kind != VECTOR_KIND:
        return (kind,) * max(1, len(seg_names))
    entries = parse_policy_vector(spec)
    if entries[0][0] is None:
        if len(entries) != max(1, len(seg_names)):
            raise ValueError(
                f"remat={spec!r}: {len(entries)} entries for "
                f"{max(1, len(seg_names))} block segment(s) "
                f"{seg_names or '(unsegmented)'}")
        return tuple(p for _, p in entries)
    by_name = dict(entries)
    if len(by_name) != len(entries):
        raise ValueError(f"remat={spec!r}: a segment is named twice")
    missing = [s for s in seg_names if s not in by_name]
    unknown = [n for n in by_name if n not in seg_names]
    if missing or unknown or not seg_names:
        raise ValueError(
            f"remat={spec!r}: named entries must cover the block segments "
            f"{seg_names} exactly; missing={missing} unknown={unknown}")
    return tuple(by_name[s] for s in seg_names)


def most_aggressive(policies) -> str:
    """The most memory-aggressive entry of a policy vector: what a
    whole-block wrap uses so it never saves more than the vector
    promised."""
    return max(policies, key=_AGGRESSIVENESS.index)


def whole_block_policy(spec: str) -> str:
    """Collapse a (possibly per-segment) spec to ONE policy for whole-block
    wraps that cannot apply a vector."""
    kind, _ = parse_remat(spec)
    if kind == AUTO_PREFIX:
        raise ValueError(
            f"remat={spec!r} reached the runtime unresolved (see "
            "resolve_segment_policies)")
    if kind != VECTOR_KIND:
        return kind
    return most_aggressive([p for _, p in parse_policy_vector(spec)])


def _save_dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _fsdp_only(fn, *args):
    with coll.regather_scope():
        return fn(*args)


def maybe_remat(fn, kind: str):
    """Wrap a function (that gathers its own parameters) per the policy."""
    if kind == "none":
        return fn
    if kind == "fsdp_only":
        return functools.partial(_fsdp_only, fn)
    if kind == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if kind == "save_dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots_policy))
    raise ValueError(f"unknown remat policy {kind!r}")
