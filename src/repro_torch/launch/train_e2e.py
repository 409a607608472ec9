"""End-to-end training driver (the port's ``examples/train_e2e.py``): a
~100M-parameter dense model for a few hundred steps, with cosine LR,
checkpointing and resume.

    PYTHONPATH=src python -m repro_torch.launch.train_e2e [--steps 300] \
        [--batch 4] [--seq 256] [--ckpt DIR] [--device cuda|cpu]

Checkpoints every 100 steps into ``--ckpt`` (a fresh temporary directory
by default), asserts the loss fell, then resumes from the last
checkpoint for 20 more steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.training.loop import train


def hundred_m_config() -> ModelConfig:
    """~100M-param llama-family config (between smollm-reduced and 360M)."""
    base = get_config("smollm-360m")
    return dataclasses.replace(
        base, name="smollm-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=1536, vocab_size=49152,
        remat=False)


def run(*, steps: int = 300, batch: int = 4, seq: int = 256,
        ckpt: str, device="cuda"):
    """Train ``hundred_m_config()`` for ``steps`` steps with a checkpoint
    every 100, assert the loss fell (the mean of the last 10 losses
    below that of the first 10), then resume from the last checkpoint
    for 20 steps. Returns both runs' ``TrainResult``s."""
    cfg = hundred_m_config()
    n = cfg.param_count() / 1e6
    print(f"training {cfg.name}: {n:.0f}M params, "
          f"{steps} steps × {batch}×{seq} tokens")
    res = train(cfg, steps=steps, batch=batch, seq=seq, checkpoint_dir=ckpt,
                checkpoint_every=100, log_every=20, device=device)
    first = sum(res.losses[:10]) / 10
    last = sum(res.losses[-10:]) / 10
    print(f"\nloss {first:.3f} -> {last:.3f} over {res.steps} steps "
          f"({res.tokens_per_s:.0f} tok/s); checkpoints in {ckpt}")
    assert last < first, "training must make progress"

    # resume from the checkpoint (restores step counter + optimizer)
    res2 = train(cfg, steps=20, batch=batch, seq=seq, checkpoint_dir=ckpt,
                 resume=True, log_every=10, device=device)
    print(f"resumed fine: continued to loss {res2.losses[-1]:.3f}")
    return res, res2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt=args.ckpt or tempfile.mkdtemp(prefix="mooncake_ckpt_"),
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
