"""Atomic, topology-independent checkpointing (port of
`repro.checkpoint.checkpointer`, in the same format).

Layout: one .npy per leaf holding the LOGICAL full array in the storage
dtype (`unshard_params`), named by its '/'-joined path with '/' -> '__',
plus `opt_step` and a JSON manifest (step, leaf index, extra).  A checkpoint
written by either package loads in the other.  The optimizer state's
error-feedback accumulator (`ef`, fp32, storage-shaped) is written as
`ef/...` leaves beside `m/` and `v/` when the state has one.  The
reference's checkpointer does not write it, and its restore of a `*_ef`
run fails on the missing leaves; the port restores a checkpoint without
them, for a config that needs one, with the accumulator at zero.  Writes go to a temp
directory that is renamed into place; an optional thread makes saves
async.  `save` takes the WHOLE storage (every rank's chunk, see
`Parallelized.unshard`); `restore` returns whole storage on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import named_leaves, tree_map
from repro_torch.models import runtime as RT


_OPT_TREES = ("m", "v", "ef")   # storage-shaped optimizer trees


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _unflatten(loaded: dict, prefix: str, template):
    """The leaves `loaded` holds under `prefix`, shaped like `template`
    (module level: a self-referencing closure would keep `loaded` alive in
    a reference cycle)."""
    if isinstance(template, dict):
        return {k: _unflatten(loaded, f"{prefix}{k}/", template[k])
                for k in sorted(template)}
    return torch.from_numpy(loaded[prefix[:-1]])


class Checkpointer:
    def __init__(self, root: str, async_save: bool = False):
        self.root = root
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(root, exist_ok=True)

    def save(self, step: int, storage, opt_state, model, dcfg: DistConfig,
             extra: dict | None = None):
        from repro_torch.core.api import unshard_params
        metas = model.metas(dcfg)
        trees = {"params": storage, **{k: opt_state[k] for k in _OPT_TREES
                                       if k in opt_state}}
        payload = dict(named_leaves({
            name: {k: unshard_params(t[k], metas[k], dcfg) for k in t}
            for name, t in trees.items()}))
        payload["opt_step"] = opt_state["step"]
        if self._thread is not None:
            self._thread.join()     # the previous async save lands first
        host = {k: _host(v) for k, v in payload.items()}

        def _write():
            tmp = os.path.join(self.root, f".tmp_step_{step}")
            final = os.path.join(self.root, f"step_{step:08d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            index = {}
            for k, v in host.items():
                fn = k.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fn), v)
                index[k] = fn
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "leaves": index,
                           "extra": extra or {}}, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)   # atomic publish

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
        return step

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest_step(self) -> int | None:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.root)
                 if d.startswith("step_")]
        return max(steps) if steps else None

    def restore(self, step: int, model, dcfg: DistConfig):
        """Returns (whole storage, opt_state, manifest) on the CPU, laid out
        for `dcfg`.  opt_state has "ef" when `dcfg.needs_ef`: the
        checkpoint's, or zeros when it holds none."""
        from repro_torch.core.api import shard_params
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        loaded = {k: np.load(os.path.join(d, fn))
                  for k, fn in manifest["leaves"].items()}
        metas = model.metas(dcfg)
        abstract = RT.model_abstract_storage(model, dcfg)

        def layout(prefix):
            logical = _unflatten(loaded, prefix, abstract)
            return {k: shard_params(logical[k], metas[k], dcfg)
                    for k in logical}

        opt_state = {"m": layout("m/"), "v": layout("v/"),
                     "step": torch.tensor(int(loaded["opt_step"]),
                                          dtype=torch.int32)}
        if dcfg.needs_ef:
            opt_state["ef"] = layout("ef/") if any(
                k.startswith("ef/") for k in loaded) else tree_map(
                lambda a: torch.zeros(a.shape, dtype=torch.float32),
                opt_state["m"])
        return layout("params/"), opt_state, manifest
