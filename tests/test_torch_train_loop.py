"""The port's train step and loop on the CPU, at ``.reduced()`` size:
the reference's training properties (``tests/test_models.py``: one step
on every config gives a finite loss in range and moves the params;
``test_loss_decreases_under_training``: 30 steps lower the loss by more
than 0.05) proven in the port, resume from a checkpoint continuing the
run bit for bit, ``launch/train_e2e.py``'s driver at reduced size, and
the train mode's choice of the differentiable plain paths."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.models.layers as TL
import repro_torch.models.mamba as TM
from repro_torch.configs.base import get_config, list_configs
from repro_torch.data.pipeline import SyntheticLM, batch_spec_for
from repro_torch.launch import train_e2e
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.training import make_optimizer, train
from repro_torch.training.loop import batch_to
from repro_torch.training.optim import tree_leaves

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list_configs())
def test_train_step_on_every_config(name):
    """One train step (forward, backward, update) on the reduced config
    with its own optimizer: a finite loss between 2 and 12, and every
    parameter leaf that a gradient reaches moved."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = batch_to(SyntheticLM(batch_spec_for(cfg, 2, 64)).batch(0), "cpu")
    init, _ = make_optimizer(cfg.optimizer)
    loss, new, st = make_train_step(cfg)(params, init(params), batch)
    assert torch.isfinite(loss) and 2.0 < float(loss) < 12.0, float(loss)
    moved = [float((a.float() - b.float()).abs().max())
             for a, b in zip(tree_leaves(params), tree_leaves(new))]
    assert max(moved) > 0
    assert all(float(m.float().abs().max()) > 0 for m in tree_leaves(st.m))


def test_loss_decreases_under_training():
    cfg = get_config("smollm-360m").reduced()
    res = train(cfg, steps=30, batch=4, seq=128, log_every=0, device="cpu")
    first = sum(res.losses[:5]) / 5
    last = sum(res.losses[-5:]) / 5
    assert last < first - 0.05, (first, last)
    assert res.steps == 30 and res.tokens == 30 * 4 * 128
    assert res.tokens_per_s > 0
    assert all(not t.requires_grad for t in tree_leaves(res.params))


def test_resume_continues_the_run_bit_for_bit(tmp_path):
    """8 steps straight, against 6 steps saved every 3 and a resume for
    2: the resumed run starts at the saved step with the saved optimizer
    step, and its losses and final params are the straight run's."""
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    kw = dict(batch=2, seq=32, log_every=0, device="cpu")
    straight = train(cfg, steps=8, **kw)
    d = str(tmp_path)
    train(cfg, steps=6, checkpoint_dir=d, checkpoint_every=3, **kw)
    resumed = train(cfg, steps=2, checkpoint_dir=d, resume=True, **kw)
    assert int(resumed.opt_state.step) == 8
    assert resumed.losses == straight.losses[6:]
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(straight.params)):
        assert torch.equal(a, b)


def test_train_e2e_driver_at_reduced_size(tmp_path, monkeypatch, capsys):
    """The driver's run: train with a checkpoint every 100 steps, the
    loss falls, then a 20-step resume from the last checkpoint."""
    small = dataclasses.replace(get_config("smollm-360m").reduced(),
                                name="smollm-100m-reduced")
    monkeypatch.setattr(train_e2e, "hundred_m_config", lambda: small)
    res, res2 = train_e2e.run(steps=200, batch=2, seq=64, ckpt=str(tmp_path),
                              device="cpu")
    assert res.steps == 200 and res2.steps == 20
    assert int(res2.opt_state.step) == 220
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000100.npz", "ckpt_00000200.npz"]
    assert "resumed fine" in capsys.readouterr().out


def test_train_mode_takes_the_differentiable_plain_paths(monkeypatch):
    """``loss_fn`` never reaches a kernel op: with the ops made to raise,
    a train-mode forward and backward of a hybrid (attention, Mamba2,
    MoE) still runs, and its loss is the one with the ops in place."""
    cfg = get_config("jamba-1.5-large-398b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = batch_to(SyntheticLM(batch_spec_for(cfg, 2, 48)).batch(0), "cpu")
    want = float(loss_fn(params, batch, cfg))

    def boom(*a, **k):
        raise AssertionError("a kernel op was called in train mode")

    monkeypatch.setattr(TL, "flash_prefill_attention", boom)
    monkeypatch.setattr(TL, "causal_attention", boom)
    monkeypatch.setattr(TM, "ssd_scan_op", boom)
    live = {k: v for k, v in params.items()}
    for leaf in tree_leaves(live):
        leaf.requires_grad_(True)
    loss = loss_fn(live, batch, cfg)
    loss.backward()
    assert float(loss.detach()) == want
    assert all(t.grad is not None for t in tree_leaves(live))
