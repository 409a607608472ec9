"""Device meshes of the port: the counterpart of the reference's
``repro/launch/mesh.py`` for the two multi-device serving paths — the
(data, model) decode mesh of sharded paged decode and the stage mesh of
Chunked Pipeline Parallelism (CPP).

One controller process drives every mesh position: a ``Mesh`` is an
array of ``torch.device`` with axis names, each shard's body runs on its
own position's device in a Python loop (CUDA launches are asynchronous,
so shards on different GPUs overlap), and the reference's collectives
become copies (an ``all_gather`` over ``model`` is a head-axis
``torch.cat``, a ``ppermute`` to the next stage is ``.to(next_device)``).
Positions may name the same device; only an explicit device array does
that — ``make_decode_mesh`` and ``make_stage_mesh`` never stack two
positions on one GPU.

The reference's XLA helpers (``compat_shard_map``, ``compat_make_mesh``,
``make_production_mesh``, ``make_test_mesh``) have no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import _to


class Mesh:
    """A device array with axis names. ``shape`` maps each axis name to
    its size (read as ``mesh.shape.get("data", 1)``, as in the
    reference); ``devices`` is the numpy object array of
    ``torch.device``, indexed in axis order."""

    def __init__(self, devices, axis_names) -> None:
        axis_names = tuple(axis_names)
        src = np.asarray(devices, dtype=object)
        if src.ndim != len(axis_names):
            raise ValueError(f"a {src.ndim}-d device array does not fit "
                             f"the axes {axis_names}")
        if src.size == 0:
            raise ValueError("a mesh needs at least one device")
        arr = np.empty(src.shape, dtype=object)
        for idx, d in np.ndenumerate(src):
            arr[idx] = torch.device(d)
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct_devices(self) -> list:
        """Every device the mesh names, once each, in position order."""
        out: list = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def replicate_params(params, mesh: Mesh) -> dict:
    """The weights placed once per distinct device of ``mesh``:
    {device: parameter tree}. Positions that share a device share one
    copy; a device the weights already live on takes them as they are."""
    return {dev: _to(params, dev) for dev in mesh.distinct_devices()}


def parse_mesh_arg(spec: str) -> tuple[int, int]:
    """``--mesh DxM`` → (data, model). Accepts '2x2', '4x1', '1x2'."""
    try:
        d, m = spec.lower().split("x")
        d, m = int(d), int(m)
    except ValueError:
        raise ValueError(
            f"--mesh wants DATAxMODEL (e.g. 2x2), got {spec!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh axes must be >= 1, got {spec!r}")
    return d, m


def _first_devices(need: int, what: str, device) -> list:
    """``need`` devices of the given kind: the CPU repeated (the
    counterpart of the reference's forced host devices), or the first
    ``need`` GPUs, refusing a host that has fewer."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * need
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device {dev}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(
            f"{what} needs {need} devices but torch sees {have} GPUs — on "
            f"the CPU pass device='cpu', or give the devices explicitly "
            f"with Mesh(...)")
    return [torch.device("cuda", i) for i in range(need)]


def make_decode_mesh(data: int, model: int, device="cuda") -> Mesh:
    """(data, model) mesh for the sharded paged decode engine: the first
    ``data*model`` GPUs (a ``RuntimeError`` naming the counts when the
    host has fewer), or with ``device="cpu"`` the CPU at every
    position."""
    devs = _first_devices(data * model, f"mesh {data}x{model}", device)
    return Mesh(np.asarray(devs, dtype=object).reshape(data, model),
                ("data", "model"))


def make_stage_mesh(stages: int, device="cuda") -> Mesh:
    """CPP pipeline mesh (§5.1): one axis of prefill-group stages, one
    GPU each (or the CPU at every stage)."""
    return Mesh(np.asarray(_first_devices(stages, f"{stages} stages",
                                          device), dtype=object),
                ("stage",))


def batch_axes_of(mesh) -> tuple:
    """Mesh axes that carry the batch dimension (everything except
    'model' / 'stage')."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
