"""Training loop: synthetic data pipeline → train step → checkpointing
(the counterpart of the reference's ``training/loop.py``), on one device
or on a (data, model) mesh.

Used by ``launch/train_e2e.py`` (a ~100M model for a few hundred steps)
and ``launch/train.py``. Params come from ``init_params`` under an
explicit ``torch.Generator(seed)`` on the training device (a mesh's
first device, then sharded by ``launch.shardings.shard_params``),
batches from ``SyntheticLM`` (split over the mesh's data rows by
``loss_fn``); every step's loss must be finite.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM, batch_spec_for
from repro_torch.launch.shardings import shard_params
from repro_torch.models.layers import NO_DIST, Dist
from repro_torch.models.transformer import init_params
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optim import make_optimizer


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)
    steps: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    #: each step's host time, batch transfer to loss read back (the
    #: read synchronises with the device)
    step_s: list = field(default_factory=list)
    #: the trained params and optimizer state (detached, on the device)
    params: Optional[dict] = None
    opt_state: Any = None

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s else 0.0


def batch_to(np_batch: dict, device) -> dict:
    """A ``SyntheticLM`` batch (numpy) → tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()}


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          seed: int = 0, checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 0, log_every: int = 10,
          resume: bool = False, device="cuda",
          dist: Dist = NO_DIST) -> TrainResult:
    """Train ``cfg`` from ``init_params`` (seed ``seed``) for ``steps``
    steps of ``batch`` × ``seq`` tokens; with ``resume``, from the latest
    checkpoint of ``checkpoint_dir`` (params, optimizer state and step).
    Saves a checkpoint every ``checkpoint_every`` steps. ``dist``: train
    on its mesh, the weights drawn on the mesh's first device (which
    stands in for ``device``) and sharded; params and optimizer state
    stay sharded in the result, and checkpoints hold whole leaves."""
    from repro_torch.launch.steps import make_train_step

    device = dist.grid()[0, 0] if dist.active else resolve_device(device)
    opt_init, _ = make_optimizer(cfg.optimizer)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    if dist.active:
        params = shard_params(cfg, params, dist.mesh)
    opt_state = opt_init(params)
    start_step = 0
    if resume and checkpoint_dir:
        loaded = load_checkpoint(checkpoint_dir, params, opt_state)
        if loaded is not None:
            params, opt_state, start_step = loaded

    step_fn = make_train_step(cfg, dist)
    pipe = SyntheticLM(batch_spec_for(cfg, batch, seq), seed=seed)

    res = TrainResult()
    t0 = time.monotonic()
    for step in range(start_step, start_step + steps):
        np_batch = pipe.batch(step)
        t_step = time.monotonic()
        loss, params, opt_state = step_fn(params, opt_state,
                                          batch_to(np_batch, device))
        loss = float(loss)
        res.step_s.append(time.monotonic() - t_step)
        assert np.isfinite(loss), f"loss diverged at step {step}: {loss}"
        res.losses.append(loss)
        res.steps += 1
        res.tokens += batch * seq
        if log_every and (step % log_every == 0):
            dt = time.monotonic() - t0
            print(f"step {step:5d}  loss {loss:7.4f}  "
                  f"{res.tokens / max(dt, 1e-9):9.0f} tok/s")
        if checkpoint_dir and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, params, opt_state, step + 1)
    res.wall_s = time.monotonic() - t0
    res.params, res.opt_state = params, opt_state
    return res
