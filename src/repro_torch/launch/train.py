"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 100 --batch 8 --seq 512 [--reduced] [--ckpt dir] \
        [--ckpt-every N] [--resume] [--seed S] [--device cuda|cpu]

Trains on one device (the GPU unless ``--device cpu``), through
``training.loop.train``. ``--mesh`` takes only ``none``: sharded
training over a (data, model) mesh is ROADMAP queue 1, item 3 (the
reference's ``prod`` meshes are TPU meshes).
"""
from __future__ import annotations

import argparse
import sys


def run(argv=None):
    """Parse the flags and train; returns the ``TrainResult``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke-scale variant")
    ap.add_argument("--mesh", default="none",
                    help="only 'none' (single device)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise ValueError(
            f"--mesh {args.mesh!r}: the port trains on one device only; "
            f"sharded training over a (data, model) mesh is ROADMAP queue "
            f"1, item 3 (the reference's prod meshes are TPU meshes)")

    from repro_torch.configs.base import get_config
    from repro_torch.training.loop import train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 seed=args.seed, checkpoint_dir=args.ckpt,
                 checkpoint_every=args.ckpt_every, resume=args.resume,
                 device=args.device)


def main(argv=None) -> int:
    res = run(argv)
    print(f"done: {res.steps} steps, final loss {res.losses[-1]:.4f}, "
          f"{res.tokens_per_s:.0f} tok/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
