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

``make_production_mesh`` gives the reference's production meshes, 16x16
and 2x16x16, as stand-in positions for the dry run (``launch.dryrun``):
host-only devices ``cpu:k`` that the dry run's stand-in tensors carry,
so every op of a step lands on its position. The reference's XLA helpers
(``compat_shard_map``, ``compat_make_mesh``, ``make_test_mesh``) have no
counterpart here.
"""
from __future__ import annotations

import math

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


# a device index is 8 bits: 127 stand-in devices at most
MAX_STANDINS = 127


def make_standin_mesh(shape, axes, *, rows=None) -> Mesh:
    """A mesh of stand-in positions for the dry run: host-only devices
    ``cpu:k``, never a GPU. A row is the positions of one index of the
    batch axes (``pod``, ``data``; the first major); in every pod, the
    first ``rows`` rows (all of them by default) take a device each per
    position, and every later row, of any pod, shares its model index's
    device with the other later rows — a class of positions that the dry
    run reads as one (the device index has 8 bits: at most
    ``MAX_STANDINS`` distinct devices)."""
    axes = tuple(axes)
    shape = tuple(shape)
    size = dict(zip(axes, shape))
    batch = [a for a in axes if a in ("pod", "data")]
    per_pod = size[batch[-1]] if batch else 1
    pods = math.prod(size[a] for a in batch[:-1])
    rows = per_pod if rows is None else min(rows, per_pod)
    per_row = math.prod(shape) // (pods * per_pod)
    own = pods * rows
    if (own + (rows < per_pod)) * per_row > MAX_STANDINS:
        raise ValueError(f"a {shape} mesh with {rows} distinct rows a pod "
                         f"needs more than {MAX_STANDINS} stand-in devices")
    arr = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        c = dict(zip(axes, idx))
        pod = 0
        for a in batch[:-1]:
            pod = pod * size[a] + c[a]
        row = c[batch[-1]] if batch else 0
        rest = 0
        for a in axes:
            if a not in ("pod", "data"):
                rest = rest * size[a] + c[a]
        slot = pod * rows + row if row < rows else own
        arr[idx] = torch.device("cpu", slot * per_row + rest)
    return Mesh(arr, axes)


# the data rows a pod of a production mesh whose positions have
# stand-ins of their own: the most rows a pod the dry run runs a step on
# (``dryrun.plan``)
PRODUCTION_ROWS = 3


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes (its ``mesh.py:44-47``): (16, 16)
    over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"), as stand-in positions (``make_standin_mesh``): the first
    ``PRODUCTION_ROWS`` data rows of each pod each position its own
    device, the later rows one device per model index."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_standin_mesh(shape, axes, rows=PRODUCTION_ROWS)


def batch_axes_of(mesh) -> tuple:
    """Mesh axes that carry the batch dimension (everything except
    'model' / 'stage')."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
