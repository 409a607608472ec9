"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 100 --batch 8 --seq 512 [--reduced] [--ckpt dir] \
        [--ckpt-every N] [--resume] [--seed S] [--device cuda|cpu] \
        [--mesh DxM]

Trains through ``training.loop.train`` on one device (the GPU unless
``--device cpu``), or with ``--mesh DxM`` on a (data, model) mesh of
D·M positions (``make_decode_mesh``: the first D·M GPUs, or the CPU at
every position with ``--device cpu``), the batch split over data and the
weights sharded by the rules of ``launch/shardings.py``. The reference's
``prod`` and ``prod-multipod`` meshes are TPU pod meshes and are
refused.
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
                    help="'none' (single device) or DATAxMODEL, e.g. 2x2")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh in ("prod", "prod-multipod"):
        raise ValueError(
            f"--mesh {args.mesh!r} is the reference's TPU pod mesh; on "
            f"GPUs give DATAxMODEL (e.g. 2x2)")

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_decode_mesh, parse_mesh_arg
    from repro_torch.launch.steps import ShapeSpec, make_dist
    from repro_torch.models.layers import NO_DIST
    from repro_torch.training.loop import train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dist = NO_DIST
    if args.mesh != "none":
        d, m = parse_mesh_arg(args.mesh)
        dist = make_dist(make_decode_mesh(d, m, device=args.device),
                         ShapeSpec("train", "train", args.seq, args.batch))
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 seed=args.seed, checkpoint_dir=args.ckpt,
                 checkpoint_every=args.ckpt_every, resume=args.resume,
                 device=args.device, dist=dist)


def main(argv=None) -> int:
    res = run(argv)
    print(f"done: {res.steps} steps, final loss {res.losses[-1]:.4f}, "
          f"{res.tokens_per_s:.0f} tok/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
