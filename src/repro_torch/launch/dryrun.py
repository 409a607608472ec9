"""Dry run of the port: per-position memory, FLOP, byte and transfer
accounting of every (architecture × input shape) on the reference's
production meshes — the counterpart of the reference's
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k [--multi-pod] [--json-out f.json] [--ops-out dir/]

Host only, as the reference's is: it touches no GPU and allocates no
model. Where the reference lowers and compiles a step for 256 or 512
placeholder TPU devices, the port runs its own step (``make_train_step``'s
``loss_and_grads`` and update, ``make_prefill_step``, ``make_serve_step``)
on stand-in tensors (``op_analysis.StandIn``: shapes, dtypes and a
device, no storage), each mesh position a stand-in device ``cpu:k``
(``launch.mesh.make_standin_mesh``), and counts what every position does
(``launch.op_analysis``). The step is the plain-PyTorch math the card
runs, less the kernels: on a CPU tensor each kernel op takes its plain
version, as the reference's dry run lowers its ``jnp`` paths.

Running a 16x16 mesh whole is slow (the single-controller mesh runs each
position's body in a Python loop), so ``count`` runs small steps and
extrapolates, exactly (``plan``):

  * depth: layers (jamba: periods) are identical, so every count is a
    polynomial in the depth — affine for a forward; quadratic for a train
    step, whose backward through each layer's view of a stacked leaf
    writes a zero-filled gradient of the whole stack. The step runs at
    1 and 2 units (1, 2 and 3 to train) and the counts are evaluated at
    the config's depth;
  * rows: the data rows (every index of the batch axes) do the same work
    on their own batch share. The step runs on the mesh's first rows (1
    and 2, ``ROW_NODES``), the parameters and optimizer state still
    sharded over the whole mesh (so the FSDP gathers over 'data', the
    gradients sent back to every shard and the optimizer's shards are
    the real ones), and every count of the first row — which also holds
    the controller's joins — is affine in the number of rows. A cut
    run's MoE layers take the whole step's dispatch
    (``Dist.moe_global_max_tokens``); the global dispatch, whose
    capacity rounds, is priced at every position by running it at the
    full token count (``_moe_dispatch_correction``). The reported
    positions are the first row's, and the positions outside it that run
    the global dispatch's experts (``_owner_records``: a later row's
    work is the second row's, plus its own part of the dispatch). A
    batch of one (``long_500k``)
    stripes its cache over every position: it runs whole, later rows
    sharing a stand-in per model index (a class, reported as its mean
    position);
  * the optimizer update does not depend on the rows: it runs once a
    depth, on the reported positions' shards (AdamW's update is per
    shard; Adafactor's sums partials across shards, so it runs on all);
  * the peak of live bytes is not a polynomial: it is estimated
    bilinear in (rows, depth) over the arguments (``plan``).

``count(cfg, shape, mesh)`` does the work for any config, ``ShapeSpec``
and mesh; ``lower_one`` is the reference's entry, on the production
meshes. The record keeps the reference's keys where they mean something:
``trace_s`` replaces ``lower_s``/``compile_s`` (there is no compile),
``memory`` is per position (the busiest reported, ``per_position``
beside it), ``cost`` and ``analysis`` are ``op_analysis``'s,
``roofline`` prices them on an H100 — all of the plain path
(``"path": "plain"``, ``dry_run``). ``--hlo-out`` becomes ``--ops-out``
(each position's op tally); ``--no-compile`` has no meaning here. The
reference's ``REPRO_DONATE`` has no counterpart: the port's steps return
fresh tensors (a decode writes its caches in place).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config, list_configs
from repro_torch.core.costmodel import H100
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.op_analysis import (COLLECTIVES, OpAnalysis,
                                            _storage, roofline_terms, standin)
from repro_torch.launch.shardings import (Sharded, _map_paths, _tree_paths,
                                          check_divisibility, param_shapes,
                                          param_specs, shard_caches)
from repro_torch.launch.steps import (INPUT_SHAPES, ShapeSpec,
                                      applicability, cache_specs,
                                      input_specs,
                                      loss_and_grads, make_dist,
                                      make_prefill_step, make_serve_step,
                                      opt_state_shapes, opt_state_specs)
from repro_torch.models import layers
from repro_torch.models.layers import NO_DIST
from repro_torch.training.optim import make_optimizer

BATCH_AXES = ("pod", "data")
# the one position of an unsharded step (``mesh`` None)
ONE = torch.device("cpu", 0)
# the peak estimate's spread, as factors of it: the plain path's peak
# was 1.06-2.43 times the card's in the three steps of chip_smoke.py's
# phase 19 (b) on an H100 (PERF.md §6), and the extrapolated peak is
# within 25% of a whole-mesh run's (tests/test_torch_dryrun.py)
PEAK_SPREAD = (1 / (2.43 * 1.25), 1.25)


# ---------------------------------------------------------------------------
# mesh rows and model depth
# ---------------------------------------------------------------------------

def n_rows(mesh) -> int:
    """The data rows of a mesh: the product of its batch axes."""
    if mesh is None:
        return 1
    return math.prod(mesh.shape.get(a, 1) for a in BATCH_AXES)


def _by_rows(mesh: Mesh) -> tuple:
    """(the devices as (rows, the other axes' sizes...) — a row per index
    of the batch axes, the first major —, the axis order that gives
    them, the batch axes' sizes)."""
    names = mesh.axis_names
    order = [i for i, a in enumerate(names) if a in BATCH_AXES] \
        + [i for i, a in enumerate(names) if a not in BATCH_AXES]
    arr = mesh.devices.transpose(order)
    lead = sum(a in BATCH_AXES for a in names)
    return arr.reshape((-1,) + arr.shape[lead:]), order, arr.shape[:lead]


def _of_rows(mesh: Mesh, rows: np.ndarray, order, lead) -> Mesh:
    """``_by_rows``' inverse: a mesh of ``mesh``'s axes, the batch axes'
    sizes ``lead``."""
    arr = rows.reshape(tuple(lead) + rows.shape[1:])
    return Mesh(arr.transpose(np.argsort(order)), mesh.axis_names)


def row_mesh(mesh: Mesh, k: int) -> Mesh:
    """The first ``k`` data rows of ``mesh`` (first batch axis major) as
    a mesh of the same axes: the batch axes' sizes 1, ..., k."""
    rows, order, lead = _by_rows(mesh)
    return _of_rows(mesh, rows[:k], order, [1] * (len(lead) - 1) + [k])


def row_devices(mesh: Mesh) -> np.ndarray:
    """The mesh's devices as a (rows, positions a row) array, in
    ``row_mesh``'s order."""
    rows, _, _ = _by_rows(mesh)
    return rows.reshape(len(rows), -1)


def _row_col(mesh: Mesh, coords: tuple) -> tuple:
    """(row, position in the row) of a position's coordinates, in
    ``row_devices``' order."""
    row = col = 0
    for a, i in zip(mesh.axis_names, coords):
        if a in BATCH_AXES:
            row = row * mesh.shape[a] + i
        else:
            col = col * mesh.shape[a] + i
    return row, col


def _with_row_distinct(mesh: Mesh, row: int) -> Mesh:
    """``mesh`` with its row ``row`` given stand-ins of its own: where it
    shares them (a later row of ``make_standin_mesh``), it trades
    devices with the last row that has its own (never the first)."""
    rows, order, lead = _by_rows(mesh)
    uses: dict = {}
    for d in rows.flat:
        uses[d] = uses.get(d, 0) + 1
    own = [r for r in range(len(rows))
           if all(uses[d] == 1 for d in rows[r].flat)]
    if row in own:
        return mesh
    if len(own) < 2:
        raise ValueError("the mesh has no row of its own stand-ins to trade")
    rows = rows.copy()
    rows[[row, own[-1]]] = rows[[own[-1], row]]
    return _of_rows(mesh, rows, order, lead)


def depth_units(cfg: ModelConfig) -> int:
    """The identical units of the stack: layers, or jamba's periods (an
    encoder-decoder's encoder layers go with its decoder layers)."""
    if cfg.encoder_layers and cfg.encoder_layers != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {cfg.encoder_layers} encoder and "
                         f"{cfg.n_layers} decoder layers are not one depth")
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else cfg.n_layers


def cut_depth(cfg: ModelConfig, units: int) -> ModelConfig:
    """``cfg`` at ``units`` depth units."""
    layers_ = units * cfg.attn_every if cfg.attn_every else units
    return dataclasses.replace(
        cfg, n_layers=layers_,
        encoder_layers=units if cfg.encoder_layers else 0)


def lagrange(nodes, x) -> list:
    """Exact weights of the polynomial through ``nodes`` evaluated at
    ``x`` (integers at integer nodes 1..3)."""
    out = []
    for i, a in enumerate(nodes):
        num = den = 1
        for j, b in enumerate(nodes):
            if j != i:
                num *= x - b
                den *= a - b
        out.append(num // den if num % den == 0 else num / den)
    return out


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def _like(meta, device):
    return standin(meta.shape, meta.dtype, device)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


class _Params:
    """Stand-in parameters (and optimizer state) of a cut config, stored over
    the whole mesh as ``shard_params`` stores them, built once per
    depth."""

    def __init__(self, cfg: ModelConfig, mesh, train: bool):
        shapes = param_shapes(cfg)
        specs = param_specs(cfg, shapes)

        def place(path, meta):
            if mesh is None:
                return standin(meta.shape, meta.dtype, ONE)
            spec = specs
            for k in path:
                spec = spec[k]
            return Sharded.build(mesh, spec, meta.shape, lambda index, dev: (
                standin([len(range(*s.indices(n))) for s, n in
                         zip(index, meta.shape)], meta.dtype, dev)))
        self.params = _map_paths(place, shapes)
        self.opt = None
        if train:
            init, _ = make_optimizer(cfg.optimizer)
            with OpAnalysis():          # its factories make stand-ins
                self.opt = init(self.params)


def step_call(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, k,
              held: _Params) -> tuple:
    """(step, arguments) of ``shape.kind`` for the first ``k`` rows of
    ``mesh`` (all of them when ``k`` is None), on stand-in inputs. A
    train step is ``loss_and_grads``; its optimizer update is
    ``_run_update``. The step picks each MoE layer's dispatch for the
    whole step's tokens, as the whole mesh would."""
    rows = n_rows(mesh) if shape.batch > 1 else 1
    sub = mesh if k is None or rows == 1 else row_mesh(mesh, k)
    if sub is not mesh:                 # the first k rows of the mesh
        whole = shape.batch * (1 if shape.kind == "decode" else shape.seq)
        most = layers.MOE_GLOBAL_DISPATCH_MAX_TOKENS
        shape = dataclasses.replace(shape, batch=shape.batch // rows * k)
        dist = dataclasses.replace(make_dist(sub, shape),
                                   moe_global_max_tokens=most
                                   if whole <= most else 0)
    else:
        dist = NO_DIST if mesh is None else make_dist(sub, shape)
    ctrl = ONE if mesh is None else dist.grid()[0, 0]
    args, _ = input_specs(cfg, shape, dist)
    stand = lambda t: _like(t, ctrl)
    if shape.kind == "train":
        step = lambda params, batch: loss_and_grads(params, batch, cfg, dist)
        call = (held.params, _map(stand, args["batch"]))
    elif shape.kind == "prefill":
        extra = {n: stand(t) for n, t in args.items() if n != "tokens"}
        step = make_prefill_step(cfg, dist)
        call = (held.params, stand(args["tokens"]), extra)
    else:
        caches = _map(stand, args["caches"]._replace(length=None))
        if mesh is not None:
            caches = shard_caches(cfg, caches, cache_specs(cfg, shape, dist),
                                  sub)
        step = make_serve_step(cfg, dist, shape)
        call = (held.params, stand(args["tokens"]),
                caches._replace(length=shape.seq - 1))
    return step, call


def _run(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, k, held: _Params,
         ops: bool):
    """``step_call``'s step under ``OpAnalysis``: (the mode, the outputs,
    the MoE branch log)."""
    step, call = step_call(cfg, shape, mesh, k, held)
    mode = OpAnalysis(ops=ops)
    mode.hold(call)
    with layers.record_moe_branches() as branches, mode:
        out = step(*call)
    return mode, out, list(branches)


def _run_update(cfg: ModelConfig, held: _Params, grads, keep, ops: bool):
    """The optimizer update of a train step on gradients like ``grads``
    under ``OpAnalysis``: (the mode, the outputs). ``keep(device)``: the
    positions to update. AdamW updates each shard on its own, so only
    those positions' shards are updated; Adafactor sums partials across
    shards, so it updates them all."""
    params, opt = held.params, held.opt
    if cfg.optimizer == "adamw":
        cut = lambda t: _keep_shards(t, keep)
        params, grads = _map_sharded(cut, params), _map_sharded(cut, grads)
        opt = opt._replace(m=_map_sharded(cut, opt.m),
                           v=_map_sharded(cut, opt.v))
    _, opt_update = make_optimizer(cfg.optimizer)
    mode = OpAnalysis(ops=ops)
    mode.hold((params, opt))
    mode.take(grads)
    with mode, torch.no_grad():
        out = opt_update(params, grads, opt)
    return mode, out


def _keep_shards(leaf, keep):
    return Sharded(leaf.mesh, leaf.spec, leaf.shape,
                   {k: t for k, t in leaf.shards.items() if keep(t.device)})


def _map_sharded(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_sharded(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_sharded(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, Sharded) else tree


def _output_bytes(out) -> dict:
    """{device: bytes} of a step's outputs, each storage once."""
    seen, acc = set(), {}
    for t in _leaves(out):
        st = _storage(t)
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        acc[t.device] = acc.get(t.device, 0) + st.nbytes()
    return acc


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "shards"):
        yield from tree.shards.values()


# ---------------------------------------------------------------------------
# flat records and their extrapolation
# ---------------------------------------------------------------------------

def _flat(rec: dict) -> dict:
    out = {k: rec[k] for k in ("flops", "bytes", "transcendentals",
                               "peak_a", "peak_b", "output_bytes")}
    for c in COLLECTIVES:
        out["coll:" + c] = rec["collective_bytes"][c]
        out["count:" + c] = rec["collective_counts"][c]
    return out


def _unflat(flat: dict) -> dict:
    coll = {c: flat["coll:" + c] for c in COLLECTIVES}
    return {"flops": flat["flops"], "bytes": flat["bytes"],
            "transcendentals": flat["transcendentals"],
            "collective_bytes": coll,
            "collective_counts": {c: flat["count:" + c]
                                  for c in COLLECTIVES},
            "collective_total": sum(coll.values()),
            "peak_over_arguments": max(flat["peak_a"], flat["peak_b"]),
            "output_bytes": flat["output_bytes"]}


def _combine(terms: list) -> dict:
    """Σ weight · record over [(weight, {label: flat record})]; a label a
    record lacks counts 0 there."""
    out: dict = {}
    for w, recs in terms:
        for lab, rec in recs.items():
            acc = out.setdefault(lab, {})
            for key, v in rec.items():
                acc[key] = acc.get(key, 0) + w * v
    return out


def position_labels(mesh: Mesh) -> dict:
    """{device: (coords, how many positions share it)}: a position's own
    stand-in is labelled by its coordinates, a shared one (a class of
    later rows) by the coordinates of its first position with the batch
    axes written ``*``."""
    if mesh is None:
        return {ONE: ((), 1)}
    where: dict = {}
    for idx in np.ndindex(*mesh.devices.shape):
        where.setdefault(mesh.devices[idx], []).append(idx)
    out = {}
    for dev, idxs in where.items():
        if len(idxs) == 1:
            out[dev] = (idxs[0], 1)
        else:
            first = tuple("*" if a in BATCH_AXES else i
                          for a, i in zip(mesh.axis_names, idxs[0]))
            out[dev] = (first, len(idxs))
    return out


def _label(coords) -> str:
    return "(" + ", ".join(str(c) for c in coords) + ")"


# ---------------------------------------------------------------------------
# argument bytes, from the specs and the port's placement
# ---------------------------------------------------------------------------

def _place(acc: dict, mesh, spec, meta) -> None:
    """Add a leaf stored by ``Sharded.build`` over ``spec`` — one block per
    index of its spec'd axes, on the position with those coordinates and
    0 on every other axis — to ``acc`` {coords: bytes} (all of it at ()
    without a mesh)."""
    if mesh is None:
        acc[()] = acc.get((), 0) + meta.numel() * meta.element_size()
        return
    spec = tuple(spec) + (None,) * (meta.dim() - len(spec))
    axes = [a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]
    blocks = math.prod(mesh.shape[a] for a in axes)
    nbytes = meta.numel() * meta.element_size() // blocks
    for idx in np.ndindex(*(mesh.shape[a] for a in axes)):
        c = dict(zip(axes, idx))
        pos = tuple(c.get(a, 0) for a in mesh.axis_names)
        acc[pos] = acc.get(pos, 0) + nbytes


def argument_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """{position coords: bytes} of what the step receives, as the port
    places it: parameters and optimizer state as ``shard_params`` and the
    optimizer's init store them (a leaf once, as the blocks its spec names:
    a replicated leaf on the mesh's first position), caches as
    ``shard_caches`` stores them by ``cache_specs``, and the step's
    inputs (tokens, labels, frames, patches) whole on the mesh's first
    position, where the step splits them into data rows."""
    dist = NO_DIST if mesh is None else make_dist(mesh, shape)
    first = () if mesh is None else (0,) * len(mesh.axis_names)
    acc: dict = {first: 0}
    p_shapes = param_shapes(cfg)
    p_specs = param_specs(cfg, p_shapes)
    for (_, meta), (_, spec) in zip(_tree_paths(p_shapes),
                                    _tree_paths(p_specs)):
        _place(acc, mesh, spec, meta)
    args, _ = input_specs(cfg, shape, dist)
    if shape.kind == "train":
        o_shapes = opt_state_shapes(cfg, p_shapes)
        o_specs = opt_state_specs(cfg, p_specs, p_shapes)
        acc[first] += o_shapes.step.numel() * o_shapes.step.element_size()
        for part, specs in ((o_shapes.m, o_specs.m), (o_shapes.v, o_specs.v)):
            for (_, meta), (_, spec) in zip(_leaf_pairs(part),
                                            _leaf_pairs(specs)):
                _place(acc, mesh, spec, meta)
        inputs = args["batch"]
    else:
        inputs = {n: t for n, t in args.items() if n != "caches"}
    for t in inputs.values():
        acc[first] += t.numel() * t.element_size()
    if shape.kind == "decode":
        specs = cache_specs(cfg, shape, dist)
        caches = args["caches"]
        for g, sg in ((caches.kv, specs.kv), (caches.ssm, specs.ssm),
                      (caches.enc_kv, specs.enc_kv)):
            if g is not None:
                for t, s in zip(g, sg):
                    _place(acc, mesh, s, t)
    return acc


def _leaf_pairs(tree, path=()):
    """(path, leaf) of a dict tree whose leaves may be tuples (Adafactor's
    factored second moment) or spec tuples of strings."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_pairs(tree[k], path + (k,))
    elif isinstance(tree, tuple) and tree and all(
            isinstance(x, (torch.Tensor, tuple)) for x in tree) and \
            not all(isinstance(x, (str, type(None))) for x in tree):
        for i, x in enumerate(tree):
            yield from _leaf_pairs(x, path + (i,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# the MoE global dispatch
# ---------------------------------------------------------------------------

def _moe_layer(cfg: ModelConfig, mesh: Mesh, train: bool) -> dict:
    """Fresh stand-in leaves of one MoE layer stored over ``mesh`` as
    ``shard_params`` stores them (autograd leaves when ``train``)."""
    held = _Params(cut_depth(cfg, 1), mesh, False).params
    group = held["ffn_moe"] if cfg.attn_every else held["moe"]
    out = {}
    for name in ("router", "w1", "w2", "w3"):
        leaf = group[name]
        while leaf.ndim > (2 if name == "router" else 3):
            leaf = leaf[0]
        out[name] = leaf.map(lambda t: t.requires_grad_(train))
    return out


def _moe_dispatch_cost(cfg: ModelConfig, tokens: int, train: bool,
                       p: dict, ctrl) -> dict:
    """{position: counts} of one global dispatch (``layers._moe_global``)
    over ``tokens`` rows routed on ``ctrl``, the experts where ``p``'s
    leaves hold them (its backward too when ``train``)."""
    h = standin((tokens, cfg.d_model), layers.DTYPE, ctrl)
    leaves = [h.requires_grad_(train)] + [
        t for leaf in p.values() for _, t in sorted(leaf.shards.items())]
    mode = OpAnalysis()
    with mode, torch.enable_grad():
        (y,), aux = layers._moe_global([h], p, cfg, np.array([[ctrl]]),
                                       tokens)
        if train:
            torch.autograd.grad(y.float().sum() + aux, leaves)
    return {dev: _flat({**t.record(), "output_bytes": 0, "peak_a": 0,
                        "peak_b": 0}) for dev, t in mode.tallies.items()}


def _moe_dispatch_correction(cfg, t: int, rows: int, mesh: Mesh,
                             train) -> dict:
    """{position: what the row extrapolation misses of one global
    dispatch}: its counts at all rows' tokens less their affine
    interpolation through the runs' row counts (``ROW_NODES``)."""
    ctrl = mesh.devices[(0,) * mesh.devices.ndim]
    p = _moe_layer(cfg, mesh, train)
    exact = _moe_dispatch_cost(cfg, rows * t, train, p, ctrl)
    approx = _combine([(w, _moe_dispatch_cost(cfg, k * t, train, p, ctrl))
                       for w, k in zip(lagrange(ROW_NODES, rows),
                                       ROW_NODES)])
    return {dev: {key: v - approx.get(dev, {}).get(key, 0)
                  for key, v in rec.items()
                  if key not in ("peak_a", "peak_b", "output_bytes")}
            for dev, rec in exact.items()}


def _owner_records(cfg, mesh: Mesh, rows: int, t: int, train: bool,
                   per_unit: int, runs: list) -> dict:
    """{label: (flat record, experts run, owners alike)} of the global
    dispatch's expert owners outside the first row
    (``layers.owner_coords``; the first row's are reported already): one
    for each model index and number of experts run, labelled by the
    first such owner, its record that of every one of them.

    A later row does what the second row does, on its own batch share,
    so each record is built from the cut runs' second and third rows at
    that model index (``runs``: [(rows k, depth j, update?, {device:
    record})]). A position of a later row runs W, its row's work, only
    where its row runs; H, the zero-filled gradients of its shards'
    stacked leaves, once whatever the rows; G, the gradients of its
    shards from each row that runs (H and G only to train); and D, its
    part of the ``per_unit`` global dispatches a depth unit at the
    step's tokens. So the k0 = 1 row runs count H + G + D(t) at the
    second row, and the k1 = 2 row runs W + H + 2G + D(2t), the third
    row's increment between them being G + D(2t) − D(t). Each is taken
    to the config's depth as ``plan`` takes the first row's (a run on
    k0 rows through its depth nodes, a further row's increment affine),
    and the owner at all R rows counts W + H + R·G + D'(R·t), D' its own
    part of the dispatch (``_moe_dispatch_cost``, run where it has a
    stand-in of its own: ``_with_row_distinct``). The peak is the second
    row's in the k1 row runs (the update's too), taken to the config's
    depth."""
    nd = mesh.devices.ndim
    p = _moe_layer(cfg, mesh, train)
    coords = [tuple(c.get(a, 0) for a in mesh.axis_names)
              for c in layers.owner_coords(p["w1"])]
    shares = layers.owner_experts(cfg.moe.n_experts, len(coords))
    groups: dict = {}
    for c, e in zip(coords, shares):
        r, col = _row_col(mesh, c)
        if r and e.stop > e.start:
            groups.setdefault((col, e.stop - e.start), []).append(c)
    if not groups:
        return {}
    by_row = row_devices(mesh)
    if len(set(by_row[:3].flat)) != by_row[:3].size:
        raise ValueError("the owners' counts read the mesh's first three "
                         "rows, which share stand-in devices")
    last = [a for a in mesh.axis_names if a in BATCH_AXES][-1]
    if train and mesh.shape[last] < 3:
        # the third row is then in another pod, whose positions hold no
        # shards (``shard_params`` stores a leaf on the first pod): its G
        # is not the owner's
        raise ValueError(f"a train step's owners are counted through the "
                         f"third row, which needs 3 indices of '{last}'")
    k0, k1 = ROW_NODES
    units = depth_units(cfg)

    def weights(k, update=False):
        nodes = sorted({j for kk, j, u, _ in runs
                        if u == update and (update or kk == k)})
        return dict(zip(nodes, lagrange(nodes, units)))
    a, b, upd = weights(k0), weights(k1), weights(k0, True)
    second, inc, peaks = [], [], []
    for k, j, u, recs in runs:
        if u:
            second.append((upd[j], recs))
            peaks.append((upd[j], recs))
        elif k == k1:
            second.append((b[j], recs))
            inc.append((b[j], recs))
            peaks.append((b[j], recs))
        else:
            second.append((a[j] - b.get(j, 0), recs))
            inc.append((-b.get(j, 0), recs))
    second, inc, peaks = _combine(second), _combine(inc), _combine(peaks)
    ctrl = mesh.devices[(0,) * nd]
    n = per_unit * units
    own = {k: _moe_dispatch_cost(cfg, k * t, train, p, ctrl)
           for k in (k0, k1)}
    at_all: dict = {}
    out = {}
    for (col, n_exp), members in sorted(groups.items()):
        rep = min(members, key=lambda c: _row_col(mesh, c))
        r = _row_col(mesh, rep)[0]
        if r not in at_all:
            m2 = _with_row_distinct(mesh, r)
            labels = position_labels(m2)
            got = _moe_dispatch_cost(cfg, rows * t, train,
                                     _moe_layer(cfg, m2, train),
                                     m2.devices[(0,) * nd])
            at_all[r] = {labels[d][0]: rec for d, rec in got.items()
                         if labels[d][1] == 1}
        d1, d2 = by_row[1, col], by_row[2, col]
        new = at_all[r].get(rep, {})
        rec = {}
        for key in second.get(d1, {}):
            if key in ("peak_a", "peak_b"):
                rec[key] = peaks.get(d1, {}).get(key, 0)
                continue
            d = lambda k, dev: own[k].get(dev, {}).get(key, 0)
            g = inc.get(d2, {}).get(key, 0) - n * (d(k1, d2) - d(k0, d2))
            rec[key] = second[d1][key] + (rows - k1) * g \
                + n * (new.get(key, 0) - d(k1, d1))
        out[_label(rep)] = (rec, n_exp, len(members))
    return out


# ---------------------------------------------------------------------------
# count: one (config, shape, mesh)
# ---------------------------------------------------------------------------

# the row counts the first row's counts are taken through: every row's
# caches and states stay on its own positions and the global dispatch's
# outputs return to them, so the first row's counts are affine from one
# row (the experts run on their owners, ``_owner_records``)
ROW_NODES = (1, 2)


def plan(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
         whole: bool = False) -> list:
    """The runs ``count`` makes and their weights: [(rows k — None for
    all —, depth units j, count weight, peak weight)].

    The counts of the first row are A(L) + (R − k0)·B(L) at R rows and
    depth L (``ROW_NODES``: k0, k1): A — a run on k0 rows — is affine in
    L (quadratic to train: the gradient of each layer's view of a stacked
    leaf is a zero-filled stack, once per layer whatever the rows), B —
    a further row's increment — affine; each is taken through its depth
    nodes and evaluated at the config's depth. The peak of live bytes is
    not a polynomial: it is taken bilinear in (rows, depth) through the
    runs at k0 and k1 rows and 1 and 2 units (the bytes that stay live
    per layer and per row, over a transient that does not grow)."""
    units = depth_units(cfg)
    rows = n_rows(mesh) if shape.batch > 1 else 1
    k0, k1 = ROW_NODES
    ja = (1, 2, 3) if shape.kind == "train" else (1, 2)
    jb = (1, 2)
    if whole or units <= ja[-1]:
        ja = jb = (units,)
    ks = (None,) if whole or rows <= k1 else (k0, k1)
    acc: dict = {}

    def put(k, j, w, pw):
        c, p = acc.get((k, j), (0, 0))
        acc[(k, j)] = (c + w, p + pw)
    a = dict(zip(ja, lagrange(ja, units)))
    b = dict(zip(jb, lagrange(jb, units)))
    r = rows - k0
    for j in ja:
        put(ks[0], j, a[j], b.get(j, 0) if len(ks) == 1 else 0)
    if len(ks) == 2:
        for j in jb:
            put(k0, j, -r * b[j], (1 - r) * b[j])
            put(k1, j, r * b[j], r * b[j])
    return [(k, j, w, pw) for (k, j), (w, pw) in
            sorted(acc.items(), key=lambda kv: (kv[0][0] or 0, kv[0][1]))
            if w or pw]


def count(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, *,
          ops: bool = False, whole: bool = False) -> dict:
    """Every reported position's counts for ``cfg``'s step at ``shape`` on
    ``mesh`` (stand-in positions, ``make_standin_mesh``): runs at cut
    depth and on the first rows (``plan``), combined exactly (module
    docstring); ``whole`` runs every row at full depth instead. The
    reported positions are those with a stand-in of their own — of the
    first row only when the rows are extrapolated, with the global
    dispatch's expert owners outside it (``_owner_records``: a record
    for each model index and number of experts, labelled by its first
    owner, with ``experts`` and ``alike``, the owners it stands for).
    Returns
    {"per_position": {label: record}, "classes": {label: record},
    "ops": {label: op tally} (``ops``), "trace_s", "runs"}."""
    train = shape.kind == "train"
    rows = n_rows(mesh) if shape.batch > 1 else 1
    if shape.batch % rows:
        raise ValueError(f"a batch of {shape.batch} does not split over "
                         f"{rows} data rows")
    runs = plan(cfg, shape, mesh, whole)
    reduced = runs[0][0] is not None
    labels = position_labels(mesh)
    # (an unsharded step is never reduced)
    first_row = set(row_devices(mesh)[0]) if reduced else None
    # the second and third rows' positions, which ``_owner_records`` reads
    later_rows = set(row_devices(mesh)[1:3].flat) if reduced else set()
    if reduced:
        k1 = max(k for k, _, _, _ in runs)
        first = row_mesh(mesh, k1).devices
        if len(set(first.flat)) != first.size:
            raise ValueError(f"the first {k1} rows of the mesh share "
                             f"stand-in devices: the plan runs on them")
    t0 = time.time()
    terms, peaks, op_terms, per_unit = [], [], [], 0
    # the second and third rows' positions in each run: [(k, j, update?,
    # {device: record with its peak})], combined by ``_owner_records``
    later = []
    upd_nodes = sorted({j for k, j, _, _ in runs if k == runs[0][0]})[:2]
    upd_w = dict(zip(upd_nodes, lagrange(upd_nodes, depth_units(cfg))))
    t_row = shape.batch // rows * (shape.seq if shape.kind != "decode"
                                   else 1)
    held_j, held = None, None

    def add(w, pw, mode, out, run, phase="peak_a"):
        outb = _output_bytes(out)
        recs = {dev: _flat({**t.record(), "peak_a": 0, "peak_b": 0,
                            "output_bytes": outb.get(dev, 0)})
                for dev, t in mode.tallies.items()}
        terms.append((w, recs))
        peaks.append((pw, {dev: {phase: t.peak - t.held}
                           for dev, t in mode.tallies.items()}))
        if reduced:
            later.append(run + ({dev: {**recs[dev], phase: t.peak - t.held}
                                for dev, t in mode.tallies.items()
                                if dev in later_rows},))
        if ops:
            op_terms.append((w, mode.op_tallies(lambda d: d)))
    for k, j, w, pw in runs:
        c = cut_depth(cfg, j)
        if held_j != j:
            held, held_j = _Params(c, mesh, train), j
        mode, out, branches = _run(c, shape, mesh, k, held, ops)
        if j:
            per_unit = branches.count("global") // j
        if not train:
            add(w, pw, mode, out, (k, j, False))
            continue
        loss, grads = out
        add(w, pw, mode, loss, (k, j, False))
        del mode, out
        if k in (runs[0][0], None) and j in upd_w:
            # the owners' records read the later rows' updates too
            keep = (lambda d: d in first_row
                    or (per_unit and d in later_rows)) \
                if reduced else (lambda d: True)
            mode, out = _run_update(c, held, grads, keep, ops)
            add(upd_w[j], upd_w[j], mode, out, (k, j, True), "peak_b")
        del grads
    per_dev = _combine(terms)
    for dev, pk in _combine([(pw, {d: {"peak_a": 0, "peak_b": 0, **r}
                                   for d, r in recs.items()})
                             for pw, recs in peaks if pw]).items():
        if dev in per_dev:
            per_dev[dev].update(pk)
    owners = {}
    if reduced and per_unit:
        fix = _moe_dispatch_correction(cfg, t_row, rows, mesh, train)
        for dev, rec in fix.items():
            for key, v in rec.items():
                if dev in per_dev:      # a position the cut runs reach
                    per_dev[dev][key] += per_unit * depth_units(cfg) * v
        owners = _owner_records(cfg, mesh, rows, t_row, train,
                                per_unit, later)
    per_position, classes = {}, {}
    for dev, rec in per_dev.items():
        coords, n = labels[dev]
        if reduced and dev not in first_row:
            continue
        if n == 1:
            per_position[_label(coords)] = _unflat(rec)
        else:
            classes[_label(coords)] = dict(
                _unflat({key: v / n for key, v in rec.items()}),
                positions=n)
    for lab, (rec, n_exp, n) in owners.items():
        per_position[lab] = dict(_unflat(rec), experts=n_exp, alike=n)
    out = {"per_position": per_position, "classes": classes,
           "trace_s": time.time() - t0,
           "runs": [[k, j] for k, j, _, _ in runs]}
    if ops:
        out["ops"] = {}
        merged = _combine([(w, {d: _flat_ops(t[d]) for d in t})
                           for w, t in op_terms])
        for dev, tal in merged.items():
            coords, n = labels[dev]
            if n == 1 and (not reduced or dev in first_row):
                out["ops"][_label(coords)] = _unflat_ops(tal)
    return out


def _flat_ops(tally: dict) -> dict:
    return {(op, what): v for op, row in tally.items()
            for what, v in row.items()}


def _unflat_ops(flat: dict) -> dict:
    out: dict = {}
    for (op, what), v in sorted(flat.items()):
        if v:
            out.setdefault(op, {})[what] = v
    return {op: row for op, row in out.items() if row.get("n")}


def busiest(per_position: dict) -> str:
    """The label of the position with the most FLOPs, then bytes, then
    collective bytes."""
    return max(per_position, key=lambda k: (
        per_position[k]["flops"], per_position[k]["bytes"],
        per_position[k]["collective_total"]))


def dry_run(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, *,
            ops: bool = False, whole: bool = False) -> dict:
    """The dry-run record of ``cfg``'s step at ``shape`` on ``mesh``:
    ``memory``, ``cost``, ``analysis`` and ``roofline`` of the busiest
    position, ``trace_s``. ``ops`` adds each position's op tally.

    Every count is the plain path's (``"path": "plain"``): the kernels'
    ops at their plain versions' cost. On the card the kernels never
    write the plain attention's logits nor the plain scan's chunks, so
    the roofline is no bound for a step that launches them (phase 19 (b)
    of ``chip_smoke.py`` ran smollm-360m's prefill in a quarter of it),
    and the peak is an estimate: ``peak_range`` spreads it by
    ``PEAK_SPREAD``, and ``fits`` is "yes" or "no" only where the whole
    range is on one side of the card's 80 GB ("unsure" otherwise)."""
    counted = count(cfg, shape, mesh, ops=ops, whole=whole)
    per = counted["per_position"]
    top = busiest(per)
    args = argument_bytes(cfg, shape, mesh)
    arg_of = {_label(c): b for c, b in args.items()}
    for lab, rec in per.items():
        rec["argument_bytes"] = arg_of.get(lab, 0)
        rec["peak_bytes"] = rec["argument_bytes"] + rec["peak_over_arguments"]
    r = per[top]
    analysis = {k: r[k] for k in ("flops", "bytes", "collective_bytes",
                                  "collective_counts", "collective_total")}
    analysis["position"] = top
    analysis["per_position"] = per
    if counted["classes"]:
        analysis["classes"] = counted["classes"]
    peak_pos = max(per, key=lambda k: per[k]["peak_bytes"])
    peak = per[peak_pos]["peak_bytes"]
    lo = max(per[peak_pos]["argument_bytes"], peak * PEAK_SPREAD[0])
    hi = peak * PEAK_SPREAD[1]
    rec = {
        "n_devices": 1 if mesh is None else int(mesh.devices.size),
        "path": "plain",
        "trace_s": round(counted["trace_s"], 1),
        "runs": counted["runs"],
        "memory": {
            "argument_bytes": max(args.values()),
            "output_bytes": max(p["output_bytes"] for p in per.values()),
            "peak_bytes": peak,
            "peak_range": [lo, hi],
            "peak_position": peak_pos,
            "fits": "yes" if hi <= H100.hbm_bytes else
                    "no" if lo > H100.hbm_bytes else "unsure",
            "argument_bytes_total": sum(args.values()),
        },
        "cost": {"flops": r["flops"], "bytes_accessed": r["bytes"],
                 "transcendentals": r["transcendentals"]},
        "analysis": analysis,
        "roofline": roofline_terms(analysis),
    }
    if ops:
        rec["ops"] = counted["ops"]
    return rec


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              ops_out: str | None = None, verbose: bool = True) -> dict:
    """Count one (arch, shape, production mesh) combination; returns the
    record (``skipped`` where the shape does not apply)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    runs, note = applicability(cfg, shape)
    if not runs:
        return {"arch": arch, "shape": shape_name, "skipped": note}
    mesh = make_production_mesh(multi_pod=multi_pod)
    bad = check_divisibility(cfg, param_shapes(cfg), mesh)
    assert not bad, f"sharding divisibility violations: {bad[:5]}"
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "note": note}
    rec.update(dry_run(cfg, shape, mesh, ops=ops_out is not None))
    if ops_out:
        os.makedirs(ops_out, exist_ok=True)
        tag = f"{arch}__{shape_name}__{rec['mesh']}"
        with open(os.path.join(ops_out, tag + ".ops.json"), "w") as f:
            json.dump(rec.pop("ops"), f, indent=1)
    if verbose:
        show = {k: v for k, v in rec.items() if k != "analysis"}
        show["analysis"] = {k: v for k, v in rec["analysis"].items()
                            if k not in ("per_position", "classes")}
        print(json.dumps(show, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ops-out", default=None,
                    help="directory for each position's op tally")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    archs = list_configs() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]

    records, failures = [], []
    for arch in archs:
        for shape in shapes:
            try:
                records.append(lower_one(arch, shape,
                                         multi_pod=args.multi_pod,
                                         ops_out=args.ops_out))
            except Exception as e:  # noqa: BLE001 — report, keep going
                failures.append((arch, shape, repr(e)[:300]))
                print(f"FAIL {arch} × {shape}: {e!r}"[:400], file=sys.stderr)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(records, f, indent=1)
    skipped = [r for r in records if "skipped" in r]
    print(f"\n{len(records) - len(skipped)} counted OK, {len(skipped)} "
          f"skipped, {len(failures)} failed")
    for r in skipped:
        print(f"  SKIP {r['arch']} × {r['shape']}: {r['skipped']}")
    for a, s, e in failures:
        print(f"  FAIL {a} × {s}: {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
