"""The port's sharding rules (``repro_torch.launch.shardings``) against
the reference's ``repro/launch/shardings.py``: ``param_specs`` leaf by
leaf (a ``PartitionSpec`` read as a tuple) and ``check_divisibility``'s
findings for all eleven configs, the reference's shapes from
``jax.eval_shape`` and the port's from ``param_shapes`` (meta tensors,
nothing allocated); then ``shard_params`` and ``gather`` on a CPU 2x2
mesh, bit for bit."""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro.launch import shardings as JS
from repro_torch.configs.base import get_config, list_configs
from repro_torch.launch.mesh import make_decode_mesh
from repro_torch.launch.shardings import (Sharded, check_divisibility,
                                          gather, gather_tree, keystr,
                                          param_shapes, param_specs,
                                          reading_pod, shard_params)
from repro_torch.models.transformer import init_params

torch.set_num_threads(1)

CONFIGS = list_configs()


class MeshShape:
    def __init__(self, **shape):
        self.shape = shape


PROD = MeshShape(pod=2, data=16, model=16)      # tests/test_distribution.py
SMALL = {"2x2": MeshShape(data=2, model=2), "1x4": MeshShape(data=1, model=4),
         # uneven: most reduced leaves violate it, so the findings differ
         # from config to config
         "3x3": MeshShape(data=3, model=3)}


@functools.lru_cache(maxsize=None)
def _shapes(name: str, reduced: bool):
    jcfg, cfg = jax_config(name), get_config(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jshapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    return jcfg, jshapes, cfg, param_shapes(cfg)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {keystr(path): tree}


@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_equal_the_reference(name):
    jcfg, jshapes, cfg, shapes = _shapes(name, False)
    ref = {jax.tree_util.keystr(p): tuple(s) for p, s in
           jax.tree_util.tree_leaves_with_path(
               JS.param_specs(jcfg, jshapes),
               is_leaf=lambda s: isinstance(s, P))}
    jsh = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in
           jax.tree_util.tree_leaves_with_path(jshapes)}
    got = _flat(param_specs(cfg, shapes))
    assert got == ref
    # the shape-only tree is the reference's, leaf by leaf, and holds no
    # storage
    flat = _flat(shapes)
    assert {k: tuple(t.shape) for k, t in flat.items()} == jsh
    assert all(t.device.type == "meta" for t in flat.values())


@pytest.mark.parametrize("name", CONFIGS)
def test_check_divisibility_equals_the_reference(name):
    jcfg, jshapes, cfg, shapes = _shapes(name, False)
    ref = JS.check_divisibility(jcfg, jshapes, PROD)
    assert check_divisibility(cfg, shapes, PROD) == ref == []
    jcfg, jshapes, cfg, shapes = _shapes(name, True)
    for mesh in SMALL.values():
        assert check_divisibility(cfg, shapes, mesh) \
            == JS.check_divisibility(jcfg, jshapes, mesh)
    assert check_divisibility(cfg, shapes, SMALL["3x3"])


@pytest.mark.parametrize("name", ["smollm-360m", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b", "whisper-large-v3"])
def test_param_specs_cover_tree(name):
    _, _, cfg, shapes = _shapes(name, False)
    leaves, specs = _flat(shapes), _flat(param_specs(cfg, shapes))
    assert leaves.keys() == specs.keys()
    assert all(len(specs[k]) <= t.dim() for k, t in leaves.items())


@pytest.mark.parametrize("name", CONFIGS)
def test_shard_then_gather_is_bitwise(name):
    """Every leaf of a ``.reduced()`` config stored once over a CPU 2x2
    mesh, as the slices its spec names, and gathered back whole: bit for
    bit; a slice along 'model' is the whole leaf's."""
    cfg = get_config(name).reduced()
    mesh = make_decode_mesh(2, 2, device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sharded = shard_params(cfg, params, mesh)
    specs = _flat(param_specs(cfg, params))
    flat, back = _flat(params), _flat(gather_tree(sharded, "cpu"))
    assert flat.keys() == back.keys()
    for k, leaf in _flat(sharded).items():
        assert isinstance(leaf, Sharded)
        assert leaf.spec == specs[k] + (None,) * (leaf.ndim - len(specs[k]))
        n = 1
        for a in leaf.spec:
            n *= {"data": 2, "model": 2, None: 1}[a]
        assert len(leaf.shards) == n             # stored once
        assert torch.equal(back[k], flat[k]) and back[k].dtype == flat[k].dtype
        if "model" in leaf.spec:
            dim = leaf.spec.index("model")
            for m in range(2):
                assert torch.equal(gather(leaf, "cpu", model=m),
                                   flat[k].chunk(2, dim)[m])
        # indexing a stacked leaf takes the layer off every shard
        if leaf.spec[0] is None and leaf.ndim > 1:
            assert torch.equal(gather(leaf[0], "cpu"), flat[k][0])


def test_shard_params_refuses_an_uneven_split():
    cfg = get_config("smollm-360m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_decode_mesh(3, 1, device="cpu")
    with pytest.raises(ValueError, match="does not shard"):
        shard_params(cfg, params, mesh)


def _pod_mesh(device_of):
    """A (2, 2, 2) mesh over ('pod', 'data', 'model') whose position
    (p, d, m) is ``device_of(p, d, m)``."""
    import numpy as np

    from repro_torch.launch.mesh import Mesh
    arr = np.empty((2, 2, 2), dtype=object)
    for idx in np.ndindex(2, 2, 2):
        arr[idx] = device_of(*idx)
    return Mesh(arr, ("pod", "data", "model"))


def test_parameters_are_replicated_over_pod():
    """On a mesh with a 'pod' axis every leaf is kept once per pod: each
    pod's slices on that pod's positions (the spec's axes at their
    index, 'data'/'model' at 0 where the spec leaves them out), a copy
    of the first pod's; a consumer reads its own pod's replica
    (``reading_pod``; stand-in positions, one device each: nothing
    crosses pods), and gathered whole, the leaf is the original bit for
    bit."""
    from repro_torch.launch.op_analysis import OpAnalysis, standin
    cfg = get_config("smollm-360m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = _pod_mesh(lambda p, d, m: torch.device("cpu"))
    sp = shard_params(cfg, params, mesh)
    for k, leaf in _flat(sp).items():
        assert leaf.pod
        blocks = len(leaf.shards) // 2
        for key, t in leaf.shards.items():
            assert torch.equal(t, leaf.shards[(0,) + key[1:]]), k
            assert leaf.coords(key)["pod"] == key[0]
        assert blocks and torch.equal(gather(leaf, "cpu"), _flat(params)[k])
    stand = _pod_mesh(lambda p, d, m: torch.device("cpu", 4 * p + 2 * d + m))
    w = Sharded.build(stand, ("data", "model"), (8, 4), lambda index, dev:
                      standin((4, 2), torch.bfloat16, dev), pod=True)
    assert {t.device for k, t in w.shards.items() if k[0] == 1} == {
        torch.device("cpu", i) for i in range(4, 8)}
    mode = OpAnalysis()
    with mode:
        with reading_pod(1):
            gather(w, torch.device("cpu", 4))
        gather(w, torch.device("cpu", 0))
    received = {d.index: t.record()["collective_total"]
                for d, t in mode.tallies.items()}
    assert received[0] == received[4] == 3 * 4 * 2 * 2


def test_each_pod_reads_its_own_replica_on_a_shared_device():
    """On a (2, 2, 2) mesh whose eight positions are all the CPU, a data
    row reads its own pod's replica, chosen by the row's 'pod'
    coordinate and not by its device: the second pod's replica of
    ``embed`` doubled moves the second pod's rows' prefill logits and
    leaves the first pod's bit for bit; and a train step's gradient
    reaches every replica of every leaf from its own pod's rows (the
    gradient taken without ``allow_unused``), the two pods' replicas of
    ``embed`` taking different gradients (different tokens)."""
    import dataclasses

    from repro_torch.launch.steps import INPUT_SHAPES, _live, make_dist
    from repro_torch.models.transformer import loss_fn, prefill
    from repro_torch.training.optim import tree_leaves, tree_map
    cfg = get_config("smollm-360m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = _pod_mesh(lambda p, d, m: torch.device("cpu"))
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], batch=8, seq=16)
    dist = make_dist(mesh, shape)
    sp = shard_params(cfg, params, mesh)
    tok = torch.randint(0, cfg.vocab_size, (8, 16),
                        generator=torch.Generator().manual_seed(3))
    emb = sp["embed"]
    moved = dict(sp, embed=emb.with_shards({
        k: t * 2 if k[0] == 1 else t for k, t in emb.shards.items()}))
    with torch.no_grad():
        base, _ = prefill(sp, tok, cfg, dist)
        got, _ = prefill(moved, tok, cfg, dist)
    assert torch.equal(got[:4], base[:4])        # rows 0, 1: the first pod
    assert (got[4:] - base[4:]).abs().amax(-1).min() > 0
    live = tree_map(_live, sp)
    leaves = list(tree_leaves(live))
    with torch.enable_grad():
        loss = loss_fn(live, {"tokens": tok, "labels": torch.roll(tok, -1, 1)},
                       cfg, dist)
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    gemb = {k: grads[id(t)] for k, t in live["embed"].shards.items()}
    for key, t in gemb.items():
        if key[0] == 0:
            assert not torch.equal(t, gemb[(1,) + key[1:]]), key


def test_pod_replicas_stay_equal_through_training():
    """smollm-360m.reduced() trained 2 AdamW steps on a (2, 2, 2) CPU
    mesh: after each step the two pods' replicas of every parameter and
    of the optimizer's moments are bit for bit equal (the gradients are
    summed over 'pod' in fp32, every replica taking the same update),
    and the loss is within 2e-2 relative of the unsharded step's."""
    import dataclasses

    from repro_torch.launch.steps import (INPUT_SHAPES, make_dist,
                                          make_train_step)
    from repro_torch.training.optim import make_optimizer
    cfg = get_config("smollm-360m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = _pod_mesh(lambda p, d, m: torch.device("cpu"))
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], batch=8, seq=32)
    init, _ = make_optimizer(cfg.optimizer)
    sp = shard_params(cfg, params, mesh)
    opt_w, opt_m = init(params), init(sp)
    whole = make_train_step(cfg)
    step = make_train_step(cfg, make_dist(mesh, shape))
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        tok = torch.randint(0, cfg.vocab_size, (8, 32), generator=gen)
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
        lw, params, opt_w = whole(params, opt_w, batch)
        lm, sp, opt_m = step(sp, opt_m, batch)
        assert abs(float(lm) - float(lw)) <= 2e-2 * abs(float(lw))
        for tree in (sp, opt_m.m, opt_m.v):
            for k, leaf in _flat(tree).items():
                for key, t in leaf.shards.items():
                    assert torch.equal(t, leaf.shards[(0,) + key[1:]]), k
