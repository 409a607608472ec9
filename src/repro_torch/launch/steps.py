"""Step functions of the port: the counterpart of the reference's
``repro/launch/steps.py``, on one device or on a (data, model) mesh
(``Dist``): the input shapes of the reference's (architecture × shape)
grid and their rules, ``make_dist``, ``make_train_step``,
``make_prefill_step``, ``make_serve_step`` (the context-parallel decode)
and, for every shape, the caches' and inputs' shapes and specs and the
optimizer state's.

Shapes are ``meta`` tensors (shape and dtype, no storage), traced under
a fake-tensor mode as ``launch.shardings.param_shapes`` traces the
parameters, so nothing of a full-size model or cache is allocated.
Specs are tuples, one mesh axis name, tuple of names or None per
dimension — the reference's ``PartitionSpec`` read as a tuple; a
``Caches`` of specs has ``length=()``. ``shard_params`` and
``shard_caches`` place real tensors by them.

Sharding: weights tensor-parallel on 'model' × FSDP on 'data'; the batch
on the mesh's pod and data axes; a KV cache's sequence on 'model'
(context-parallel decode: the memory-bound KV read is striped across a
data row's model positions), or, with a batch of one (``long_500k``), on
every axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.shardings import (Sharded, batch_entry, pad_seq,
                                          pod_sum, seq_axes)
from repro_torch.models.layers import NO_DIST, Dist
from repro_torch.models.mamba import MambaState
from repro_torch.models.transformer import (Caches, KVCache, decode_step,
                                            init_caches, loss_fn, prefill)
from repro_torch.training.optim import (OptState, make_optimizer,
                                        tree_leaves, tree_map)

SERVE_WINDOW = 8192   # sliding-window serving variant for dense long_500k


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int
    long: bool = False


INPUT_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1, long=True),
}


def applicability(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether this (arch, shape) runs, and how."""
    if shape.name != "long_500k":
        return True, ""
    if cfg.max_decode_len and cfg.max_decode_len < shape.seq:
        return False, (f"decoder architecturally capped at "
                       f"{cfg.max_decode_len} tokens — skip")
    if cfg.kind in ("ssm", "hybrid"):
        return True, "constant-state SSM path (+ KV for hybrid attn layers)"
    if cfg.sliding_window:
        return True, f"native SWA window={cfg.sliding_window} (ring cache)"
    return True, f"sliding-window serving variant (--serve-window {SERVE_WINDOW})"


def serve_window(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Effective attention window for a decode shape (0 = full)."""
    if shape.name != "long_500k":
        return cfg.sliding_window
    if cfg.kind in ("ssm", "hybrid"):
        return cfg.sliding_window
    return cfg.sliding_window or SERVE_WINDOW


def make_dist(mesh, shape: ShapeSpec) -> Dist:
    """The mesh's batch axes carry the batch — none for a batch of one
    (``long_500k``: nothing to shard on batch)."""
    batch_axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    if shape.batch == 1:
        batch_axes = ()
    return Dist(mesh=mesh, batch_axes=batch_axes)


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _map_leaves(fn, tree):
    """``fn`` over the tensors of nested dicts, tuples and NamedTuples
    (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_map_leaves(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def cache_shapes(cfg: ModelConfig, shape: ShapeSpec) -> Caches:
    """``init_caches`` of a decode at ``shape`` (its serving window, an
    encoder-decoder's ``frontend_tokens`` of encoder K/V) as meta
    tensors; the length an int32 scalar, as in the reference."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    window = serve_window(cfg, shape)
    enc_len = cfg.frontend_tokens if cfg.encoder_layers else 0
    with FakeTensorMode():
        fake = init_caches(cfg, shape.batch, shape.seq, enc_len=enc_len,
                           window=window, device="cpu")
    return _map_leaves(_meta, fake)._replace(
        length=torch.empty((), dtype=torch.int32, device="meta"))


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, dist: Dist) -> Caches:
    """Spec tuples of ``cache_shapes``' leaves: KV (layers, batch, seq,
    KV, Dh) with the batch on the batch axes and the sequence on
    ``seq_axes``; a Mamba2 state's heads and conv channels on 'model';
    an encoder's K/V by batch only."""
    del shape    # the reference's signature: the layout is the dist's
    b = batch_entry(dist)
    seq = seq_axes(dist)
    kv = ssm = enc_kv = None
    if cfg.attention_layers:
        kv = KVCache(k=(None, b, seq, None, None),
                     v=(None, b, seq, None, None))
    if cfg.ssm is not None and cfg.kind in ("ssm", "hybrid"):
        if cfg.attn_every:
            ssm = MambaState(ssm=(None, None, b, "model", None, None),
                             conv=(None, None, b, None, "model"))
        else:
            ssm = MambaState(ssm=(None, b, "model", None, None),
                             conv=(None, b, None, "model"))
    if cfg.encoder_layers:
        enc_kv = KVCache(k=(None, b, None, None, None),
                         v=(None, b, None, None, None))
    return Caches(kv=kv, ssm=ssm, enc_kv=enc_kv, length=())


def input_specs(cfg: ModelConfig, shape: ShapeSpec, dist: Dist):
    """(args: a dict of meta-tensor stand-ins, specs: the matching spec
    tuples) for the step of ``shape.kind``: train {batch: tokens, labels
    [, patches | frames]}, prefill {tokens [, patches | frames]}, decode
    {tokens (B, 1), caches}. Tokens are int32, frames and patches fp32,
    as in the reference."""
    b = batch_entry(dist)
    B, S = shape.batch, shape.seq

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    def tok(s):
        return meta((B, s), torch.int32)

    def frontend(args, specs):
        name = {"patch": "patches", "audio": "frames"}.get(cfg.frontend)
        if name is not None:
            args[name] = meta((B, cfg.frontend_tokens, cfg.d_model),
                              torch.float32)
            specs[name] = (b, None, "model")

    args: dict = {}
    specs: dict = {}
    if shape.kind == "train":
        args["batch"] = {"tokens": tok(S), "labels": tok(S)}
        specs["batch"] = {"tokens": (b, None), "labels": (b, None)}
        frontend(args["batch"], specs["batch"])
    elif shape.kind == "prefill":
        args["tokens"] = tok(S)
        specs["tokens"] = (b, None)
        frontend(args, specs)
    else:
        args["tokens"] = tok(1)
        specs["tokens"] = (b, None)
        args["caches"] = cache_shapes(cfg, shape)
        specs["caches"] = cache_specs(cfg, shape, dist)
    return args, specs


def _live(p):
    """A leaf's fresh autograd leaves (every shard of a sharded one)."""
    if isinstance(p, Sharded):
        return p.map(lambda t: t.detach().requires_grad_(True))
    return p.detach().requires_grad_(True)


def loss_and_grads(params, batch, cfg: ModelConfig, dist: Dist = NO_DIST):
    """(loss, grads) of ``loss_fn`` at ``params``: the loss a detached
    fp32 scalar tensor, the gradients a dict like the params (a sharded
    leaf's gradient sharded like it, each shard where it lives — autograd
    through the gathers sums every consumer's part, each pod's replica
    its own pod's; then the replicas' gradients are summed over 'pod'
    (``shardings.pod_sum``), so every replica takes the same update).
    ``loss_fn`` runs in its train mode, so no kernel is launched."""
    live = tree_map(_live, params)
    with torch.enable_grad():
        loss = loss_fn(live, batch, cfg, dist)
        grads = iter(torch.autograd.grad(loss, list(tree_leaves(live)),
                                         allow_unused=True))

    def take(p):
        if not isinstance(p, Sharded):
            return _used(next(grads), p)
        g = p.map(lambda _: next(grads))
        for key, t in g.shards.items():
            # a pod's replica none of its rows read — the global MoE
            # dispatch runs on the first pod — takes a zero gradient and,
            # through the pod sum, the others'; any other leaf must be read
            if t is None and p.pod and any(
                    g.shards[(q,) + key[1:]] is not None
                    for q in range(p.mesh.shape["pod"])):
                g.shards[key] = torch.zeros_like(p.shards[key])
            else:
                _used(t, p)
        return g
    return loss.detach(), pod_sum(tree_map(take, live))


def _used(grad, leaf):
    if grad is None:
        raise RuntimeError(f"no gradient reaches a {tuple(leaf.shape)} "
                           f"parameter: the loss does not read it")
    return grad


def make_train_step(cfg: ModelConfig, dist: Dist = NO_DIST):
    """``train_step(params, opt_state, batch) -> (loss, new_params,
    new_opt_state)``: ``loss_and_grads``, then ``cfg.optimizer``'s
    update (on each shard where it lives, for sharded params). The new
    params are fresh leaf tensors that do not require grad; ``params`` is
    left as it was."""
    _, opt_update = make_optimizer(cfg.optimizer)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg, dist)
        with torch.no_grad():
            new_params, new_opt = opt_update(params, grads, opt_state)
        return loss, new_params, new_opt

    return train_step


def make_prefill_step(cfg: ModelConfig, dist: Dist = NO_DIST):
    """``prefill_step(params, tokens, extra) -> (logits, caches)``, the
    forward without grad (the kernels are forward-only); ``extra`` is
    {} or {'frames': ...} / {'patches': ...} (stub modality
    embeddings). On a mesh the logits are joined on its first position
    and the caches come back ``Sharded`` by ``cache_specs`` (the
    reference's ``out_shardings``), ready for ``make_serve_step``."""
    def prefill_step(params, tokens, extra):
        with torch.no_grad():
            return prefill(params, tokens, cfg, dist,
                           frames=extra.get("frames"),
                           patches=extra.get("patches"))

    return prefill_step


def make_serve_step(cfg: ModelConfig, dist: Dist, shape: ShapeSpec):
    """``serve_step(params, tokens, caches) -> (logits, caches)``: one
    ``decode_step`` without grad at ``shape``'s serving window, a ring
    buffer when the cache is sized at a window shorter than the shape's
    sequence. On a mesh the params come from ``shard_params`` and the
    caches from ``shard_caches`` (by ``cache_specs``): the KV sequence
    striped over a data row's model positions (over every position for
    a batch of one), each Mamba2 state's heads over 'model'. Caches whose
    KV has fewer slots than the shape's — a prefill's (``prefill_step``),
    which hold just the prompt — are given the shape's slots on the way
    in (``pad_seq``: zero slots, each stripe copied from the stripes
    that hold it), so the step takes a prefill's caches as they are."""
    window = serve_window(cfg, shape)
    ring = bool(window) and window < shape.seq
    kv = cache_shapes(cfg, shape).kv
    slots = None if kv is None else kv.k.shape[2]

    def serve_step(params, tokens, caches):
        if slots is not None and caches.kv.k.shape[2] < slots:
            caches = caches._replace(kv=KVCache(
                *(pad_seq(t, slots, 2) for t in caches.kv)))
        with torch.no_grad():
            return decode_step(params, tokens, caches, cfg, dist, ring=ring,
                               window_override=window or None)

    return serve_step


def opt_state_shapes(cfg: ModelConfig, param_shapes) -> OptState:
    """``cfg.optimizer``'s initial state for ``param_shapes`` (meta
    tensors, ``launch.shardings.param_shapes``), as meta tensors: traced
    under a fake-tensor mode, nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    init, _ = make_optimizer(cfg.optimizer)
    with FakeTensorMode():
        fake = init(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                             param_shapes))
    return _map_leaves(_meta, fake)


def opt_state_specs(cfg: ModelConfig, p_specs, param_shapes) -> OptState:
    """OptState specs: m and v follow the parameter; Adafactor's factored
    v (row, col) drop the last / second-to-last parameter axis."""
    if cfg.optimizer == "adamw":
        return OptState(step=(), m=p_specs, v=p_specs)

    def v_spec(spec, shp):
        ndim = len(shp.shape)
        if ndim < 2:          # unfactored second moment
            return spec
        t = tuple(spec) + (None,) * (ndim - len(spec))
        return (t[:-1], t[:-2] + t[-1:])

    return OptState(step=(), m=p_specs,
                    v=tree_map(v_spec, p_specs, param_shapes))
