"""Sharding rules of the port: the counterpart of the reference's
``repro/launch/shardings.py``. Parameters are 2-D sharded —
tensor-parallel over 'model', FSDP over 'data' — and replicated over
'pod'; optimizer state follows its parameter.

Rules are by parameter ROLE (the dict path), not shape, so every
architecture maps through one table, as in the reference. A spec is a
plain tuple with one mesh axis name (or None) per leaf dimension — the
reference's ``PartitionSpec`` read as a tuple.

Where the reference hands a spec tree to XLA (``named``), the port
stores the slices itself: ``shard_params`` keeps each leaf as the slices
its spec names, once per index of 'pod' (the reference's replication
over 'pod', so that no step reads a parameter across pods), each slice
on the device of its mesh position (the position whose spec'd axes take
the slice's index, 'pod' its replica's, the other axes 0), in a
``Sharded`` leaf. An axis other than 'pod' that a spec leaves unnamed
keeps one copy, at index 0 (the norms, the biases and the router on
'data' or 'model'). A consumer takes what it needs, from its own pod's
replica (``reading_pod``: the mesh code enters each data row's pod), with
``gather``: the full leaf, or the full leaf's slice along
'model' — a ``torch.cat`` of shards moved to the consumer's device (the
FSDP all-gather) — or with ``take`` any slice of the full leaf, from the
shards that hold it. Autograd through those copies sends each shard its
part of the gradient, summed over every consumer of its pod (the
reduce-scatter), with no code of its own; a train step then sums the
replicas' gradients over 'pod' (``pod_sum``).

Decode caches are placed the same way by ``shard_caches``, from
``launch.steps.cache_specs``: a spec entry there may name several axes
(a ``long_500k`` sequence over ('data', 'model')), the first major.

Every copy between positions is a part of some collective of the
reference's. A copy that is not a gather names its kind with
``collective``: the dry run (``launch.op_analysis``) counts it so.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

Spec = tuple

# role → spec (leading L/stack axes are added automatically)
_RULES: dict[str, Spec] = {
    # embeddings
    "embed":        ("model", "data"),
    "lm_head":      ("data", "model"),
    "final_ln":     (),
    "enc_final_ln": (),
    # attention (flat head*dim last axes)
    "attn.ln":      (),
    "attn.wq":      ("data", "model"),
    "attn.wk":      ("data", "model"),
    "attn.wv":      ("data", "model"),
    "attn.wo":      ("model", "data"),
    "attn.bq":      ("model",),
    "attn.bk":      ("model",),
    "attn.bv":      ("model",),
    "attn.q_norm":  (),
    "attn.k_norm":  (),
    # dense MLP
    "mlp.ln":       (),
    "mlp.w1":       ("data", "model"),
    "mlp.w2":       ("model", "data"),
    "mlp.w3":       ("data", "model"),
    # MoE, expert-parallel (experts on 'model'; experts lead after stack)
    "moe.ln":       (),
    "moe.router":   ("data", None),
    "moe.w1":       ("model", "data", None),
    "moe.w2":       ("model", None, "data"),
    "moe.w3":       ("model", "data", None),
    # MoE, tensor-parallel experts (few-expert models: expert FF hidden on
    # 'model' — mixtral's 8 experts < model axis 16)
    "moe_tp.ln":     (),
    "moe_tp.router": ("data", None),
    "moe_tp.w1":     (None, "data", "model"),
    "moe_tp.w2":     (None, "model", "data"),
    "moe_tp.w3":     (None, "data", "model"),
    # Mamba2
    "mamba.ln":       (),
    "mamba.in_proj":  ("data", "model"),
    "mamba.conv_w":   (None, "model"),
    "mamba.dt_bias":  (),
    "mamba.A_log":    (),
    "mamba.D":        (),
    "mamba.norm":     ("model",),
    "mamba.out_proj": ("model", "data"),
}

# how many leading stack axes each top-level group carries
_STACK_DEPTH = {
    "attn": 1, "mlp": 1, "moe": 1, "mamba": 1,
    "enc_attn": 1, "enc_mlp": 1, "cross_attn": 1,
    # jamba period-scan groups: (n_per, inner, ...)
    "ffn_dense": 2, "ffn_moe": 2,
}
_GROUP_ALIAS = {
    "enc_attn": "attn", "enc_mlp": "mlp", "cross_attn": "attn",
    "ffn_dense": "mlp", "ffn_moe": "moe",
}


def _spec_for(path: tuple, leaf, cfg: ModelConfig, hybrid: bool) -> Spec:
    top = path[0]
    if top in ("embed", "lm_head", "final_ln", "enc_final_ln"):
        return _RULES[top]
    group = _GROUP_ALIAS.get(top, top)
    stack = _STACK_DEPTH.get(top, 1)
    if hybrid and top == "mamba":
        stack = 2  # (n_per, inner, ...)
    if group == "moe" and cfg.moe is not None and cfg.moe.parallelism == "tp":
        group = "moe_tp"
    rule = _RULES[f"{group}.{path[-1]}"]
    ndim = len(leaf.shape)
    spec = ((None,) * stack + tuple(rule))[:ndim]
    return spec + (None,) * (ndim - len(spec))


def _tree_paths(tree, path=()):
    """(path, leaf) pairs of a nested dict, in sorted key order (jax's
    pytree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_paths(tree[k], path + (k,))
    else:
        yield path, tree


def _map_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a dict path: ``['attn']['wq']``."""
    return "".join(f"[{k!r}]" for k in path)


def param_specs(cfg: ModelConfig, params: Any) -> Any:
    """A dict like ``params`` (tensors, meta tensors or ``param_shapes``)
    with each leaf's spec tuple."""
    hybrid = bool(cfg.attn_every)
    return _map_paths(lambda path, leaf: _spec_for(path, leaf, cfg, hybrid),
                      params)


def check_divisibility(cfg: ModelConfig, params, mesh) -> list[str]:
    """Every sharded dim must divide by its mesh axes. Returns violations
    (empty = good), in the reference's words. ``mesh``: anything with a
    ``shape`` dict of axis sizes."""
    specs = param_specs(cfg, params)
    bad: list[str] = []
    for (path, leaf), (_, spec) in zip(_tree_paths(params),
                                       _tree_paths(specs)):
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * len(leaf.shape)):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            size = 1
            for a in axes:
                size *= mesh.shape[a]
            if dim % size:
                bad.append(f"{keystr(path)}: {dim} % {size}")
    return bad


def param_shapes(cfg: ModelConfig) -> dict:
    """``init_params``' tree as ``meta`` tensors (shape and dtype, no
    storage): it is traced under a fake-tensor mode, so not even jamba's
    398 B parameters are allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import init_params
    with FakeTensorMode():
        fake = init_params(cfg, torch.Generator(), "cpu")
    return _map_paths(lambda _, t: torch.empty(t.shape, dtype=t.dtype,
                                               device="meta"), fake)


# ---------------------------------------------------------------------------
# sharded leaves
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    """The mesh axes of one spec entry: None, a name or a tuple of names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def axis_size(mesh, entry) -> int:
    """How many blocks a dimension with spec ``entry`` splits into."""
    return math.prod(mesh.shape[a] for a in _axes(entry))


class Sharded:
    """One leaf stored over a mesh: the slices its spec names, once per
    index of 'pod' where ``pod`` is set (the parameters' replicas).

    ``spec`` has one entry per dimension of the full ``shape``: None, a
    mesh axis name, or a tuple of names (the dimension split over their
    product, the first axis major — XLA's layout of ``P(("data",
    "model"))``); ``shards`` maps a key — the replica's 'pod' index where ``pod`` is
    set, then one block index per sharded dimension, in dimension order — to
    that slice, on the device of its position. Indexing (``leaf[l]``)
    takes one entry of an unsharded leading axis (a layer of a stack)
    off every shard, as views."""

    __slots__ = ("mesh", "spec", "shape", "shards", "pod", "_replicas")

    def __init__(self, mesh, spec: Spec, shape, shards: dict,
                 pod: bool = False) -> None:
        self.mesh = mesh
        self.shape = tuple(shape)
        # a rule shorter than the leaf leaves its trailing dims unsharded
        self.spec = tuple(spec) + (None,) * (len(self.shape) - len(spec))
        self.shards = shards
        self.pod = pod
        self._replicas = None

    @classmethod
    def build(cls, mesh, spec: Spec, shape, make,
              pod: bool = False) -> "Sharded":
        """``make(index, device)`` → the slice at ``index`` (a tuple of
        slices into the full shape) for its position's device, once per
        index of 'pod' with ``pod``."""
        leaf = cls(mesh, spec, shape, {}, pod)
        for dim, a in zip(leaf.shape, leaf.spec):
            if dim % axis_size(mesh, a):
                raise ValueError(f"a {leaf.shape} leaf does not split evenly "
                                 f"over {leaf.spec} on {mesh.shape}")
        for key in itertools.product(
                *([range(mesh.shape["pod"])] if pod else []),
                *(range(axis_size(mesh, leaf.spec[i]))
                  for i in leaf.dims())):
            leaf.shards[key] = make(leaf.index(key), position_device(
                mesh, leaf.coords(key)))
        return leaf

    def with_shards(self, shards: dict) -> "Sharded":
        """A leaf laid out like this one holding ``shards``."""
        return Sharded(self.mesh, self.spec, self.shape, shards, self.pod)

    def local(self) -> dict:
        """{block key: slice} of the replica the reads in scope take: the
        pod's that ``reading_pod`` names (the first's outside every
        scope)."""
        if not self.pod:
            return self.shards
        if self._replicas is None:
            self._replicas = {}
            for k, t in self.shards.items():
                self._replicas.setdefault(k[0], {})[k[1:]] = t
        return self._replicas[_READS.pod]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        return next(iter(self.shards.values())).dtype

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def dims(self) -> list:
        """The sharded dimensions, in order: the positions of a key."""
        return [i for i, a in enumerate(self.spec) if a is not None]

    def coords(self, key) -> dict:
        """{mesh axis: index} of a key."""
        out = {"pod": key[0]} if self.pod else {}
        for i, k in zip(self.dims(), key[self.pod:]):
            for a in reversed(_axes(self.spec[i])):
                out[a] = k % self.mesh.shape[a]
                k //= self.mesh.shape[a]
        return out

    def part(self, coords: dict, device) -> torch.Tensor:
        """This leaf's slice at the mesh position ``coords`` (axes this
        leaf is not sharded over are ignored), moved to ``device``."""
        key = [coords.get("pod", 0)] if self.pod else []
        for i in self.dims():
            k = 0
            for a in _axes(self.spec[i]):
                k = k * self.mesh.shape[a] + coords[a]
            key.append(k)
        return self.shards[tuple(key)].to(device)

    def __getitem__(self, i: int) -> "Sharded":
        if self.spec[0] is not None:
            raise ValueError(f"indexing a leaf sharded on its first axis "
                             f"({self.spec})")
        return Sharded(self.mesh, self.spec[1:], self.shape[1:],
                       {k: t[i] for k, t in self.shards.items()}, self.pod)

    def block(self, dim: int, i: int) -> "Sharded":
        """Block ``i`` of sharded dimension ``dim`` (a data row's part of
        a batch-sharded leaf): the shards that hold it, that dimension
        no longer sharded."""
        j = self.pod + self.dims().index(dim)
        shape = list(self.shape)
        shape[dim] //= axis_size(self.mesh, self.spec[dim])
        spec = self.spec[:dim] + (None,) + self.spec[dim + 1:]
        return Sharded(self.mesh, spec, shape,
                       {k[:j] + k[j + 1:]: t for k, t in self.shards.items()
                        if k[j] == i}, self.pod)

    def map(self, fn, *others: "Sharded"):
        """``fn`` over the aligned shards of this leaf and ``others`` (same
        spec); a tuple result gives a tuple of leaves."""
        out = {k: fn(t, *(o.shards[k] for o in others))
               for k, t in self.shards.items()}
        first = next(iter(out.values()))
        if isinstance(first, tuple):
            return tuple(self.with_shards({k: v[j] for k, v in out.items()})
                         for j in range(len(first)))
        return self.with_shards(out)

    def like(self, full: torch.Tensor) -> "Sharded":
        """``full`` (this leaf's shape) split the way this leaf is, each
        slice on its shard's device in its shard's dtype."""
        return self.with_shards({
            k: full[self.index(k)].to(device=t.device, dtype=t.dtype,
                                      copy=True)
            for k, t in self.shards.items()})

    def index(self, key) -> tuple:
        """The slices of the full leaf that shard ``key`` holds."""
        index = [slice(None)] * self.ndim
        for i, k in zip(self.dims(), key[self.pod:]):
            w = self.shape[i] // axis_size(self.mesh, self.spec[i])
            index[i] = slice(k * w, (k + 1) * w)
        return tuple(index)

    def __repr__(self) -> str:
        pod = ", replicated over 'pod'" if self.pod else ""
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"{len(self.shards)} shards{pod})")


def position_device(mesh, coords: dict) -> torch.device:
    """The device of the mesh position with ``coords`` on its named axes
    and index 0 on every other axis."""
    return mesh.devices[tuple(coords.get(a, 0) for a in mesh.axis_names)]


def pod_replicated(mesh) -> bool:
    """Whether ``shard_params`` keeps a replica of each leaf per index of
    'pod': where the mesh has that axis (no rule names it)."""
    return "pod" in mesh.axis_names


class _Reads(threading.local):
    pod = 0


_READS = _Reads()


@contextlib.contextmanager
def reading_pod(pod: int):
    """``with reading_pod(q):`` — the reads of a pod-replicated leaf made
    inside (``gather``, ``take``) take pod ``q``'s replica. The mesh code
    enters it for each data row with the row's 'pod' coordinate
    (``layers.each_row``), so a row reads its own pod's replica whatever
    device its positions are on; outside every scope the reads take the
    first pod's."""
    prev, _READS.pod = _READS.pod, pod
    try:
        yield
    finally:
        _READS.pod = prev


def pod_sum(grads):
    """A dict of gradients (``loss_and_grads``') with each sharded leaf's
    pod replicas summed over 'pod': every replica's slice receives the
    others' (one all-reduce), adds them in fp32 in pod order and rounds
    once to the gradient's dtype — so every replica takes the same
    update and the replicas stay equal bit for bit. A leaf without
    replicas is returned as it is."""
    if isinstance(grads, dict):
        return {k: pod_sum(v) for k, v in grads.items()}
    if not isinstance(grads, Sharded) or not grads.pod:
        return grads
    out = {}
    for key, t in grads.shards.items():
        parts = [grads.shards[(q,) + key[1:]]
                 for q in range(grads.mesh.shape["pod"])]
        with collective("all-reduce", held=True):
            acc = parts[0].to(t.device).float()
            for u in parts[1:]:
                acc = acc + u.to(t.device).float()
        out[key] = acc.to(t.dtype)
    return grads.with_shards(out)


def shard_params(cfg: ModelConfig, params, mesh) -> dict:
    """``params`` stored over ``mesh`` by the rules, a replica per index
    of 'pod' (``pod_replicated``): a dict of
    ``Sharded`` leaves (copies: ``params`` is left as it is). Raises
    ``ValueError`` with ``check_divisibility``'s findings when a sharded
    dimension does not divide by its axis."""
    bad = check_divisibility(cfg, params, mesh)
    if bad:
        raise ValueError(f"{cfg.name} does not shard over {mesh.shape}: "
                         f"{bad[:5]}")
    specs = param_specs(cfg, params)
    return _map_paths(
        lambda path, t: Sharded.build(
            mesh, _lookup(specs, path), t.shape,
            lambda index, dev: t[index].to(dev, copy=True),
            pod_replicated(mesh)), params)


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class _Kind(threading.local):
    kind = None
    held = False


_KIND = _Kind()


class collective:
    """``with collective(kind):`` — the copies between positions made
    inside are one collective of ``kind``, the reference's name for it:
    "all-reduce" (a sum or max of the positions' partials sent to where
    it is taken), "reduce-scatter" (each position's slice of such a
    sum), "all-to-all" (expert-parallel slabs) or "collective-permute"
    (a pipeline stage's hand-off). A copy outside any scope is a gather
    (``gather``, ``take``, a row split or join, a value sent to a model
    position) — "all-gather" to the dry run, which reads the kind
    (``collective_kind``); nothing else does.

    ``held=True`` marks the copies of a collective whose algorithm the
    reference fixes — one it writes by hand (``_moe_ep``'s all-to-all
    pair, ``_moe_tp``'s psum, the MoE aux pmean) or one XLA computes by
    a fixed rule (the global dispatch's fp32 partial sums, the gradient
    sum over 'pod'): ``tests/test_torch_op_analysis.py`` holds their
    bytes per position against the reference's compiled collectives, and
    the dry run reports them apart (``collective_held``)."""

    __slots__ = ("kind", "held", "prev")

    def __init__(self, kind: str, held: bool = False) -> None:
        self.kind = kind
        self.held = held

    def __enter__(self) -> None:
        self.prev = (_KIND.kind, _KIND.held)
        _KIND.kind, _KIND.held = self.kind, self.held

    def __exit__(self, *exc) -> None:
        _KIND.kind, _KIND.held = self.prev


def collective_kind():
    """The kind of the innermost ``collective`` scope entered on this
    thread (None outside every scope)."""
    return _KIND.kind


def collective_held() -> bool:
    """Whether the innermost ``collective`` scope is a held one."""
    return _KIND.held


def gather(leaf, device, model=None, model_axis: str = "model"):
    """A consumer's view of one leaf, on ``device``: the full leaf, or
    with ``model`` the full leaf's slice ``model`` along ``model_axis``
    (every other sharded axis gathered), from the replica of the
    consumer's pod (``reading_pod``). A plain tensor is taken whole;
    ``model`` then needs a sharded leaf."""
    if not isinstance(leaf, Sharded):
        if model is not None:
            raise ValueError("a model slice of an unsharded leaf")
        return leaf.to(device)
    dims = leaf.dims()
    shards = leaf.local()
    keys = sorted(shards)
    if model is not None:
        if model_axis not in leaf.spec:
            raise ValueError(f"{leaf} is not sharded over {model_axis!r}")
        j = dims.index(leaf.spec.index(model_axis))
        keys = [k for k in keys if k[j] == model]

    def assemble(keys, i):
        if i == len(dims):
            return shards[keys[0]].to(device)
        parts = [assemble([k for k in keys if k[i] == g], i + 1)
                 for g in sorted({k[i] for k in keys})]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dims[i])
    return assemble(keys, 0)


def take(leaf, device, index: tuple) -> torch.Tensor:
    """``leaf``'s full-leaf slice ``index`` (a tuple of step-1 slices, one
    per leading dimension) on ``device``, copied only from the shards
    that hold part of it in the consumer's pod's replica
    (``reading_pod``) — a column range of a weight gathered over 'data' from the 'model' stripes it
    crosses, a data row of a batch-sharded state. A plain tensor is
    sliced."""
    if not isinstance(leaf, Sharded):
        return leaf[index].to(device)
    want = []
    for d, n in enumerate(leaf.shape):
        lo, hi, _ = (index[d] if d < len(index)
                     else slice(None)).indices(n)
        want.append((lo, hi))
    dims = leaf.dims()
    shards = leaf.local()
    widths = [leaf.shape[d] // axis_size(leaf.mesh, leaf.spec[d])
              for d in dims]
    blocks = [[g for g in range(axis_size(leaf.mesh, leaf.spec[d]))
               if g * w < want[d][1] and (g + 1) * w > want[d][0]]
              for d, w in zip(dims, widths)]

    def assemble(key, i):
        if i == len(dims):
            local = list(want)
            for d, g, w in zip(dims, key, widths):
                local[d] = (max(want[d][0] - g * w, 0),
                            min(want[d][1] - g * w, w))
            t = shards[tuple(key)]
            return t[tuple(slice(lo, hi) for lo, hi in local)].to(device)
        parts = [assemble(key + [g], i + 1) for g in blocks[i]]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dims[i])
    return assemble([], 0)


def stack_sharded(leaves: list) -> "Sharded":
    """Leaves of one spec and shape → one leaf with a new unsharded
    leading axis, each shard the stack of the leaves' shards."""
    first = leaves[0]
    return Sharded(first.mesh, (None,) + first.spec,
                   (len(leaves),) + first.shape,
                   {k: torch.stack([x.shards[k] for x in leaves])
                    for k in first.shards}, first.pod)


def shard_caches(cfg: ModelConfig, caches, specs, mesh):
    """``caches`` (a ``models.transformer.Caches`` of whole tensors)
    stored once over ``mesh`` by ``specs`` (``launch.steps.cache_specs``):
    every KV, Mamba2-state and encoder K/V leaf a ``Sharded`` leaf of
    copies, the length as it is. A KV sequence striped over 'model'
    gives position j the contiguous slots [j·S/M, (j+1)·S/M); over
    ('data', 'model') the stripe index is data-major. Raises
    ``ValueError`` when a dimension does not split evenly."""
    def place(t, spec):
        if t is None:
            return None
        if spec is None:
            raise ValueError(f"{cfg.name}: a cache leaf without a spec")
        return Sharded.build(mesh, spec, t.shape,
                             lambda index, dev: t[index].to(dev, copy=True))

    def group(g, sg):
        if g is None:
            return None
        return type(g)(*(place(t, s) for t, s in zip(g, sg)))
    return caches._replace(kv=group(caches.kv, specs.kv),
                           ssm=group(caches.ssm, specs.ssm),
                           enc_kv=group(caches.enc_kv, specs.enc_kv))


def batch_entry(dist):
    """The spec entry of a batch dimension split into ``dist``'s data
    rows (``cache_specs``' ``b``): None for one unsplit batch (without a
    mesh, the batch axes as they are named)."""
    b = tuple(a for a in dist.batch_axes
              if dist.mesh is None or a in dist.mesh.axis_names)
    if not b:
        return None
    return b[0] if len(b) == 1 else b


def seq_axes(dist):
    """Axes striping a KV-cache sequence dim: 'model', plus the other
    axes (data, pod) when the batch does not use them (a batch of one)."""
    if batch_entry(dist) is not None:
        return "model"
    free = tuple(a for a in dist.mesh.axis_names if a != "model")
    return free + ("model",)


def shard_rows(rows: list, spec: Spec, mesh, *,
               batch_dim: int = 0) -> Sharded:
    """One leaf given as its data rows' blocks (``rows``: one tensor per
    block of dimension ``batch_dim``, each on its row's device) stored
    over ``mesh`` by ``spec``, as ``shard_caches`` would store the rows
    joined — without joining them: each shard is copied from its row
    alone. Raises ``ValueError`` when a dimension does not split evenly
    or the rows do not match the batch's split."""
    first = rows[0]
    if axis_size(mesh, spec[batch_dim]) != len(rows):
        raise ValueError(f"{len(rows)} rows do not match a batch split "
                         f"over {spec[batch_dim]} on {mesh.shape}")
    shape = list(first.shape)
    shape[batch_dim] *= len(rows)

    def make(index, dev):
        r = (index[batch_dim].start or 0) // first.shape[batch_dim]
        local = list(index)
        local[batch_dim] = slice(None)
        part = rows[r][tuple(local)]
        if part.shape == rows[r].shape:      # the row whole: no copy
            return part.to(dev)
        return part.to(dev, copy=True)
    return Sharded.build(mesh, spec, shape, make)


def pad_seq(leaf, length: int, dim: int):
    """``leaf`` zero-padded along ``dim`` to ``length`` slots: a tensor by
    concatenation; a ``Sharded`` leaf laid out anew by its spec, each
    new shard copied only from the shards that hold its part (``take``).
    Raises ``ValueError`` when the leaf is longer or the new length does
    not split evenly."""
    n = leaf.shape[dim]
    if length < n:
        raise ValueError(f"{n} positions do not fit {length} slots")
    if length == n:
        return leaf
    if not isinstance(leaf, Sharded):
        pad = list(leaf.shape)
        pad[dim] = length - n
        return torch.cat([leaf, leaf.new_zeros(pad)], dim=dim)
    shape = list(leaf.shape)
    shape[dim] = length

    def make(index, dev):
        lo, hi, _ = index[dim].indices(length)
        cut = (min(lo, n), min(hi, n))
        size = [len(range(*s.indices(m))) for s, m in zip(index, shape)]
        if cut[1] == cut[0]:
            return torch.zeros(size, dtype=leaf.dtype, device=dev)
        src = list(index)
        src[dim] = slice(*cut)
        part = take(leaf, dev, tuple(src))
        if hi > cut[1]:
            size[dim] = hi - cut[1]
            part = torch.cat([part, part.new_zeros(size)], dim=dim)
        return part
    return Sharded.build(leaf.mesh, leaf.spec, shape, make)


def gather_tree(tree, device):
    """``gather`` over a dict of leaves: every leaf whole on ``device``."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    return gather(tree, device)
