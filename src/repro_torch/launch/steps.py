"""Step functions of the port: the counterpart of the reference's
``repro/launch/steps.py`` for training and prefill, on one device or on a
(data, model) mesh (``Dist``): the input shapes of the reference's
(architecture × shape) grid and their rules, ``make_dist``,
``make_train_step``, ``make_prefill_step`` and the optimizer state's
specs.

The rest of that module — ``cache_shapes``, ``cache_specs``,
``input_specs``, ``make_serve_step`` (the context-parallel decode) and
``opt_state_shapes`` — feeds the reference's XLA lowering and is not
copied here (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.shardings import Sharded
from repro_torch.models.layers import NO_DIST, Dist
from repro_torch.models.transformer import loss_fn, prefill
from repro_torch.training.optim import (OptState, make_optimizer,
                                        tree_leaves, tree_map)

SERVE_WINDOW = 8192   # sliding-window serving variant for dense long_500k


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int
    long: bool = False


INPUT_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1, long=True),
}


def applicability(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether this (arch, shape) runs, and how."""
    if shape.name != "long_500k":
        return True, ""
    if cfg.max_decode_len and cfg.max_decode_len < shape.seq:
        return False, (f"decoder architecturally capped at "
                       f"{cfg.max_decode_len} tokens — skip")
    if cfg.kind in ("ssm", "hybrid"):
        return True, "constant-state SSM path (+ KV for hybrid attn layers)"
    if cfg.sliding_window:
        return True, f"native SWA window={cfg.sliding_window} (ring cache)"
    return True, f"sliding-window serving variant (--serve-window {SERVE_WINDOW})"


def serve_window(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Effective attention window for a decode shape (0 = full)."""
    if shape.name != "long_500k":
        return cfg.sliding_window
    if cfg.kind in ("ssm", "hybrid"):
        return cfg.sliding_window
    return cfg.sliding_window or SERVE_WINDOW


def make_dist(mesh, shape: ShapeSpec) -> Dist:
    """The mesh's batch axes carry the batch — none for a batch of one
    (``long_500k``: nothing to shard on batch)."""
    batch_axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    if shape.batch == 1:
        batch_axes = ()
    return Dist(mesh=mesh, batch_axes=batch_axes)


def _live(p):
    """A leaf's fresh autograd leaves (every shard of a sharded one)."""
    if isinstance(p, Sharded):
        return p.map(lambda t: t.detach().requires_grad_(True))
    return p.detach().requires_grad_(True)


def loss_and_grads(params, batch, cfg: ModelConfig, dist: Dist = NO_DIST):
    """(loss, grads) of ``loss_fn`` at ``params``: the loss a detached
    fp32 scalar tensor, the gradients a dict like the params (a sharded
    leaf's gradient sharded like it, each shard where it lives — autograd
    through the gathers sums every consumer's part). ``loss_fn`` runs in
    its train mode, so no kernel is launched."""
    live = tree_map(_live, params)
    with torch.enable_grad():
        loss = loss_fn(live, batch, cfg, dist)
        grads = iter(torch.autograd.grad(loss, list(tree_leaves(live))))

    def take(p):
        if isinstance(p, Sharded):
            return p.map(lambda _: next(grads))
        return next(grads)
    return loss.detach(), tree_map(take, live)


def make_train_step(cfg: ModelConfig, dist: Dist = NO_DIST):
    """``train_step(params, opt_state, batch) -> (loss, new_params,
    new_opt_state)``: ``loss_and_grads``, then ``cfg.optimizer``'s
    update (on each shard where it lives, for sharded params). The new
    params are fresh leaf tensors that do not require grad; ``params`` is
    left as it was."""
    _, opt_update = make_optimizer(cfg.optimizer)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg, dist)
        with torch.no_grad():
            new_params, new_opt = opt_update(params, grads, opt_state)
        return loss, new_params, new_opt

    return train_step


def make_prefill_step(cfg: ModelConfig, dist: Dist = NO_DIST):
    """``prefill_step(params, tokens, extra) -> (logits, caches)``, the
    forward without grad (the kernels are forward-only); ``extra`` is
    {} or {'frames': ...} / {'patches': ...} (stub modality
    embeddings)."""
    def prefill_step(params, tokens, extra):
        with torch.no_grad():
            return prefill(params, tokens, cfg, dist,
                           frames=extra.get("frames"),
                           patches=extra.get("patches"))

    return prefill_step


def opt_state_specs(cfg: ModelConfig, p_specs, param_shapes) -> OptState:
    """OptState specs: m and v follow the parameter; Adafactor's factored
    v (row, col) drop the last / second-to-last parameter axis."""
    if cfg.optimizer == "adamw":
        return OptState(step=(), m=p_specs, v=p_specs)

    def v_spec(spec, shp):
        ndim = len(shp.shape)
        if ndim < 2:          # unfactored second moment
            return spec
        t = tuple(spec) + (None,) * (ndim - len(spec))
        return (t[:-1], t[:-2] + t[-1:])

    return OptState(step=(), m=p_specs,
                    v=tree_map(v_spec, p_specs, param_shapes))
