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
                                          shard_params)
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
