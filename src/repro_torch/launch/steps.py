"""The training step of the port: the counterpart of the reference's
``make_train_step`` (``repro/launch/steps.py``). The rest of that module
— the input shapes, shardings and step functions it lowers to XLA for
TPU meshes — is tooling the port replaces with its own accounting
later (ROADMAP queue 1, item 4), so it is not copied here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import loss_fn
from repro_torch.training.optim import tree_leaves, make_optimizer, tree_map


def loss_and_grads(params, batch, cfg: ModelConfig):
    """(loss, grads) of ``loss_fn`` at ``params``: the loss a detached
    fp32 scalar tensor, the gradients a dict like the params. ``loss_fn``
    runs in its train mode, so no kernel is launched."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch, cfg)
        grads = iter(torch.autograd.grad(loss, list(tree_leaves(live))))
    return loss.detach(), tree_map(lambda _: next(grads), live)


def make_train_step(cfg: ModelConfig):
    """``train_step(params, opt_state, batch) -> (loss, new_params,
    new_opt_state)``: ``loss_and_grads``, then ``cfg.optimizer``'s
    update. The new params are fresh leaf tensors that do not require
    grad; ``params`` is left as it was."""
    _, opt_update = make_optimizer(cfg.optimizer)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg)
        with torch.no_grad():
            new_params, new_opt = opt_update(params, grads, opt_state)
        return loss, new_params, new_opt

    return train_step
