"""Checkpointing: flat-name ``.npz`` snapshots of (params, opt_state,
step), in the reference's format (``training/checkpoint.py``), so either
package reads the other's checkpoints.

Archive names are the reference's ``jax.tree_util.keystr`` paths, written
here by a small flattener of our own: ``p`` + ``['attn']['wq']`` for a
parameter, ``o.step``, ``o.m['embed']`` and ``o.v['mlp']['w1'][0]`` (a
factored Adafactor row) for the optimizer state, and ``__step__``. bf16
leaves are stored as fp32 (lossless) and cast back to the dtype of the
leaf they restore into. The file is written under a temporary name in the
same directory and renamed into place, so a crash never leaves a torn
checkpoint (the reference's ``np.savez`` also leaves an empty ``.tmp``
file behind; this writes through the open descriptor and leaves none).

A sharded run (``launch.shardings.Sharded`` leaves) saves each leaf
gathered whole, so its checkpoint is the same archive an unsharded run
writes, and loads into either; a sharded leaf loaded is split again the
way it was.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.launch.shardings import Sharded, gather
from repro_torch.training.optim import OptState


def _paths(tree: Any, prefix: str):
    """(keystr path, leaf) pairs: dict keys as ``['k']``, tuple items as
    ``[i]``, an ``OptState``'s fields as ``.step``/``.m``/``.v``."""
    if isinstance(tree, OptState):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), f"{prefix}.{name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _paths(t, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _flatten(tree: Any, prefix: str) -> dict:
    flat = {}
    for key, leaf in _paths(tree, prefix):
        t = gather(leaf, "cpu").detach()
        if t.dtype == torch.bfloat16:       # numpy has no bf16: store f32
            t = t.float()
        flat[key] = t.cpu().numpy()
    return flat


def _unflatten(tree: Any, prefix: str, archive) -> Any:
    """``tree`` with every leaf replaced by its stored value, cast to the
    leaf's dtype and placed on its device."""
    def load(key, leaf):
        full = torch.from_numpy(np.asarray(archive[key]))
        if isinstance(leaf, Sharded):
            return leaf.like(full)
        return full.to(device=leaf.device, dtype=leaf.dtype)

    def walk(t, p):
        if isinstance(t, OptState):
            return OptState(*(walk(getattr(t, n), f"{p}.{n}")
                              for n in t._fields))
        if isinstance(t, dict):
            return {k: walk(v, f"{p}[{k!r}]") for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, f"{p}[{i}]") for i, v in enumerate(t))
        return load(p, t)
    return walk(tree, prefix)


def save_checkpoint(dir_: str, params, opt_state, step: int) -> str:
    """Write ``ckpt_{step:08d}.npz`` into ``dir_``; returns its path."""
    os.makedirs(dir_, exist_ok=True)
    flat = {"__step__": np.asarray(step)}
    flat.update(_flatten(params, "p"))
    flat.update(_flatten(opt_state, "o"))
    path = os.path.join(dir_, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=dir_, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def latest_checkpoint(dir_: str) -> Optional[str]:
    if not os.path.isdir(dir_):
        return None
    ckpts = sorted(f for f in os.listdir(dir_)
                   if re.match(r"ckpt_\d+\.npz$", f))
    return os.path.join(dir_, ckpts[-1]) if ckpts else None


def load_checkpoint(dir_: str, params, opt_state):
    """Restore the latest checkpoint of ``dir_`` into the given
    (shape-matched) params and optimizer state. Returns (params,
    opt_state, step), or None if there is no checkpoint."""
    path = latest_checkpoint(dir_)
    if path is None:
        return None
    with np.load(path) as z:
        step = int(z["__step__"])
        params = _unflatten(params, "p", z)
        opt_state = _unflatten(opt_state, "o", z)
    return params, opt_state, step
