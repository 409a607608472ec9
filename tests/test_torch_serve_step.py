"""The port's serve step on a (data, model) mesh — ``make_serve_step``,
the context-parallel decode over ``shard_caches``' stripes — and the
step module's shape functions, against the reference's
``repro/launch/steps.py``.

* ``cache_shapes``, ``cache_specs``, ``input_specs`` and
  ``opt_state_shapes`` for all eleven configs and four shapes at full
  size: shapes, dtypes and spec tuples equal the reference's (its
  ``ShapeDtypeStruct``s and ``PartitionSpec``s read as tuples).
* The reference's ``make_serve_step``, jitted with ``param_specs`` /
  ``cache_specs`` shardings on a 2x2 mesh of 4 forced host devices (as
  ``lower_one`` builds it; ONE subprocess for the file, started first),
  against the port's on a 2x2 mesh of CPU positions, same weights
  (``bridge``) and caches (one numpy seed), the port fed the reference's
  tokens and, for the MoE layers, its routing (recorded through a
  ``jax.debug.callback`` in a wrapped ``_route``: XLA's compiled router
  can route a near-tie otherwise, ROADMAP §3): logits within 2e-2 of
  their scale, or 1.25x the reference's own sharded-vs-unsharded spread
  where that is larger, and greedy tokens equal wherever the
  reference's top-2 gap exceeds 4e-2 (``tests/test_torch_model.py``'s
  rule). A ``decode_32k``-like shape (4 slots over 2 data rows, 64-slot caches)
  and a ``long_500k`` one with ``seq`` cut to 16,384, so the dense
  ring (8,192 slots, striped over all four positions) has wrapped.
* Inside the port: the serve step on (1, 4), (2, 2) and (4, 1) against
  the unsharded ``decode_step`` over the same caches, 16 steps teacher-
  forced on the unsharded stream, every family: logits within 4 bf16
  ulps of the largest (6 for the routed families, 8e-2 of the scale
  for jamba's hybrid over the free run and 4e-2 for one step from the
  same caches: ``_bound``), and the argmax equal wherever the unsharded
  top-2 gap exceeds twice the bound (two runs within it each way cannot
  reorder it). The caches come back whole, within 2e-2 of the unsharded
  run's (the hybrid's 4e-2).
Measured values go into the test report (``record_property``).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models.transformer as JT
from conftest import SRC
from repro.configs.base import get_config as jax_config
from repro.launch import steps as JSTEPS
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config, list_configs
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import make_decode_mesh
from repro_torch.launch.shardings import (Sharded, gather, param_shapes,
                                          shard_caches, shard_params)
from repro_torch.models import layers as L
from repro_torch.models.layers import NO_DIST
from repro_torch.models.transformer import init_caches, init_params

torch.set_num_threads(1)

TOL = 2e-2
GAP = 4e-2
HYBRID_TOL = 4e-2
SPREAD = 1.25       # times the reference's own sharded-vs-unsharded gap
REF_STEPS = 3
PORT_STEPS = 16
CONFIGS = list_configs()


class FakeMesh:
    """Axis names and sizes: all the specs read of a mesh."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"2x2": dict(data=2, model=2),
          "prod": dict(pod=2, data=16, model=16)}


# ---------------------------------------------------------------------------
# shapes and specs, full size
# ---------------------------------------------------------------------------

def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _flat(tree, path=""):
    """path → leaf over dicts, tuples and NamedTuples (None kept out), in
    the reference's keystr form."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}[{k!r}]"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{path}.{k}"))
        return out
    if isinstance(tree, tuple) and tree and not all(
            x is None or isinstance(x, (str, tuple)) for x in tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}[{i}]"))
        return out
    return {path: tree}


def _ref_flat(tree):
    """The same over the reference's pytrees (PartitionSpecs as tuples,
    ShapeDtypeStructs as (shape, dtype))."""
    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda s: isinstance(s, P))
    for path, leaf in leaves:
        key = "".join(f".{k.name}" if hasattr(k, "name") else
                      f"[{k.key!r}]" if hasattr(k, "key") else f"[{k.idx}]"
                      for k in path)
        out[key] = tuple(leaf) if isinstance(leaf, P) \
            else (tuple(leaf.shape), str(leaf.dtype))
    return out


def _shapes(tree) -> dict:
    return {k: (tuple(t.shape), _dtype(t.dtype)) for k, t in
            _flat(tree).items()}


@pytest.mark.parametrize("shape", list(STEPS.INPUT_SHAPES))
@pytest.mark.parametrize("name", CONFIGS)
def test_cache_and_input_specs_equal_the_reference(name, shape):
    """``cache_shapes`` (meta tensors, nothing allocated),
    ``cache_specs`` and ``input_specs`` on a 2x2 and the production mesh
    against the reference's, leaf by leaf."""
    cfg, jcfg = get_config(name), jax_config(name)
    sh, jsh = STEPS.INPUT_SHAPES[shape], JSTEPS.INPUT_SHAPES[shape]
    got = STEPS.cache_shapes(cfg, sh)
    assert all(t.device.type == "meta" for t in _flat(got).values())
    assert _shapes(got) == _ref_flat(JSTEPS.cache_shapes(jcfg, jsh))
    for axes in MESHES.values():
        mesh = FakeMesh(**axes)
        dist, jdist = STEPS.make_dist(mesh, sh), JSTEPS.make_dist(mesh, jsh)
        assert _flat(STEPS.cache_specs(cfg, sh, dist)) \
            == _ref_flat(JSTEPS.cache_specs(jcfg, jsh, jdist))
        args, specs = STEPS.input_specs(cfg, sh, dist)
        jargs, jspecs = JSTEPS.input_specs(jcfg, jsh, jdist)
        assert _shapes(args) == _ref_flat(jargs)
        assert _flat(specs) == _ref_flat(jspecs)


@pytest.mark.parametrize("name", CONFIGS)
def test_opt_state_shapes_equal_the_reference(name):
    """``opt_state_shapes`` of ``param_shapes`` against the reference's
    ``jax.eval_shape`` of its optimizer's init: the step, m, and v (a
    factored (row, col) pair for Adafactor's matrices)."""
    cfg, jcfg = get_config(name), jax_config(name)
    got = STEPS.opt_state_shapes(cfg, param_shapes(cfg))
    jshapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    want = _ref_flat(JSTEPS.opt_state_shapes(jcfg, jshapes))
    assert all(t.device.type == "meta" for t in _flat(got).values())
    assert _shapes(got) == want


def test_seq_axes_rule():
    """The KV sequence stripes over 'model' when the batch is sharded,
    else over every other axis and then 'model'."""
    cfg = get_config("smollm-360m")
    mesh = FakeMesh(pod=2, data=2, model=2)
    for shape, seq in (("decode_32k", "model"),
                       ("long_500k", ("pod", "data", "model"))):
        dist = STEPS.make_dist(mesh, STEPS.INPUT_SHAPES[shape])
        spec = STEPS.cache_specs(cfg, STEPS.INPUT_SHAPES[shape], dist)
        assert spec.kv.k[2] == seq and spec.length == ()


# ---------------------------------------------------------------------------
# the serve step against the reference's, 2x2
# ---------------------------------------------------------------------------

# (tag, config, shape, batch, seq, length)
SERVE_CASES = [
    ("smollm-32k", "smollm-360m", "decode_32k", 4, 64, 56),
    ("smollm-500k", "smollm-360m", "long_500k", 1, 16384, 9000),
    ("qwen3-14b-32k", "qwen3-14b", "decode_32k", 4, 64, 56),
    ("qwen3-14b-500k", "qwen3-14b", "long_500k", 1, 16384, 9000),
    ("mixtral-32k", "mixtral-8x7b", "decode_32k", 4, 64, 56),
    ("mixtral-500k", "mixtral-8x7b", "long_500k", 1, 16384, 1000),
    ("whisper-32k", "whisper-large-v3", "decode_32k", 4, 64, 56),
    ("mamba2-32k", "mamba2-2.7b", "decode_32k", 4, 64, 56),
    ("mamba2-500k", "mamba2-2.7b", "long_500k", 1, 16384, 9000),
    ("jamba-32k", "jamba-1.5-large-398b", "decode_32k", 4, 64, 56),
    ("jamba-500k", "jamba-1.5-large-398b", "long_500k", 1, 16384, 9000),
]

REFERENCE = r'''
import dataclasses, os, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.models.layers as L
from repro.configs.base import get_config
from repro.launch.mesh import make_test_mesh
from repro.launch.shardings import param_specs
from repro.launch.steps import (INPUT_SHAPES, cache_specs, make_dist,
                                make_serve_step)
from repro.models.mamba import MambaState
from repro.models.transformer import Caches, KVCache, init_params

CASES, STEPS, in_dir, out_dir = (eval(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])
rec = []
route = L._route


def recording(xf, w, k):
    """The reference's _route, its expert ids sent to the host (decode
    sizes take the global dispatch: one call a MoE layer, in order)."""
    g, idx, aux = route(xf, w, k)
    jax.debug.callback(lambda i: rec.append(np.asarray(i)), idx)
    return g, idx, aux


L._route = recording
mesh = make_test_mesh(2, 2)
named = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                                  is_leaf=lambda s: isinstance(s, P))
for tag, name, shape_name, B, seq, length in CASES:
    cfg = get_config(name).reduced()
    shape = dataclasses.replace(INPUT_SHAPES[shape_name], batch=B, seq=seq)
    dist = make_dist(mesh, shape)
    params = init_params(cfg, jax.random.PRNGKey(0))
    d = dict(np.load(os.path.join(in_dir, tag + ".npz")))
    bf = lambda k: jnp.asarray(d[k]).astype(jnp.bfloat16)
    caches = Caches(
        kv=KVCache(bf("kv.k"), bf("kv.v")) if "kv.k" in d else None,
        ssm=MambaState(jnp.asarray(d["ssm.ssm"]), bf("ssm.conv"))
        if "ssm.ssm" in d else None,
        enc_kv=KVCache(bf("enc_kv.k"), bf("enc_kv.v"))
        if "enc_kv.k" in d else None,
        length=jnp.asarray(length, jnp.int32))
    b = dist.batch_axes or None
    if isinstance(b, tuple) and len(b) == 1:
        b = b[0]
    c_shard = named(cache_specs(cfg, shape, dist))
    step = jax.jit(make_serve_step(cfg, dist, shape),
                   in_shardings=(named(param_specs(cfg, params)),
                                 NamedSharding(mesh, P(b, None)), c_shard),
                   out_shardings=(NamedSharding(mesh, P()), c_shard))
    whole = jax.jit(make_serve_step(cfg, L.NO_DIST, shape))
    eager = make_serve_step(cfg, L.NO_DIST, shape)
    tok = d["tokens"]
    out = {}
    one = eg = caches
    for t in range(STEPS):
        with mesh:
            logits, caches = step(params, tok, caches)
        jax.effects_barrier()
        for n, i in enumerate(rec):
            out[f"route/{t}/{n}"] = i
        rec.clear()
        # the reference's own spread: its unsharded step on the same
        # tokens from its own unsharded caches
        logits1, one = whole(params, tok, one)
        if cfg.moe is not None:
            # and op by op: compiled XLA keeps the bf16 router product in
            # fp32, so the gates differ (ROADMAP §3); the hybrid's stack
            # amplifies that
            with jax.disable_jit():
                logitsE, eg = eager(params, tok, eg)
            out[f"logitsE/{t}"] = np.asarray(logitsE.astype(jnp.float32))
        jax.effects_barrier()
        rec.clear()
        if cfg.attn_every:      # the hybrid's caches after each step
            for f in ("kv", "ssm"):
                for k, a in zip(getattr(caches, f)._fields,
                                getattr(caches, f)):
                    out[f"caches/{t}/{f}.{k}"] = np.asarray(
                        a.astype(jnp.float32))
        out[f"tokens/{t}"] = np.asarray(tok)
        out[f"logits/{t}"] = np.asarray(logits.astype(jnp.float32))
        out[f"logits1/{t}"] = np.asarray(logits1.astype(jnp.float32))
        tok = np.asarray(jnp.argmax(logits, axis=-1).astype(jnp.int32))
    np.savez(os.path.join(out_dir, tag + ".tmp.npz"), **out)
    os.replace(os.path.join(out_dir, tag + ".tmp.npz"),
               os.path.join(out_dir, tag + ".npz"))
'''


def _shape(shape: str, batch: int, seq: int):
    return dataclasses.replace(STEPS.INPUT_SHAPES[shape], batch=batch,
                               seq=seq)


def _random_caches(cfg, sh, length: int, seed: int):
    """``init_caches`` of the shape filled from one numpy seed: KV, conv
    state and encoder K/V bf16 N(0, 1), the SSM state fp32 N(0, 0.3²)."""
    window = STEPS.serve_window(cfg, sh)
    enc = cfg.frontend_tokens if cfg.encoder_layers else 0
    c = init_caches(cfg, sh.batch, sh.seq, enc_len=enc, window=window,
                    device="cpu")
    rng = np.random.default_rng(seed)

    def fill(t, scale=1.0):
        x = rng.standard_normal(tuple(t.shape)).astype(np.float32) * scale
        return torch.from_numpy(x).to(t.dtype)
    kv = c.kv and type(c.kv)(*(fill(t) for t in c.kv))
    ssm = c.ssm and type(c.ssm)(fill(c.ssm.ssm, 0.3), fill(c.ssm.conv))
    enc_kv = c.enc_kv and type(c.enc_kv)(*(fill(t) for t in c.enc_kv))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (sh.batch, 1)).astype(np.int32))
    return c._replace(kv=kv, ssm=ssm, enc_kv=enc_kv, length=length), tokens


def _copy(caches):
    return caches._replace(**{f: None if getattr(caches, f) is None else
                              type(getattr(caches, f))(
                                  *(t.clone() for t in getattr(caches, f)))
                              for f in ("kv", "ssm", "enc_kv")})


def _npz(caches, tokens) -> dict:
    out = {"tokens": tokens.numpy()}
    for f in ("kv", "ssm", "enc_kv"):
        g = getattr(caches, f)
        if g is not None:
            for k in g._fields:
                out[f"{f}.{k}"] = getattr(g, k).float().numpy()
    return out


def _from_npz(like, d: dict, prefix: str):
    """``like`` (a Caches) with its KV and Mamba2 state from ``d``."""
    def group(g, f):
        if g is None:
            return None
        return type(g)(*(torch.from_numpy(d[f"{prefix}{f}.{k}"]).to(t.dtype)
                         for k, t in zip(g._fields, g)))
    return like._replace(kv=group(like.kv, "kv"), ssm=group(like.ssm, "ssm"))


def _port_params(name: str):
    cfg = get_config(name).reduced()
    jp = JT.init_params(jax_config(name).reduced(), jax.random.PRNGKey(0))
    return cfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _wait_for(proc, path: str, timeout: float = 900.0):
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if proc.poll() is not None and not os.path.exists(path):
            raise AssertionError(f"the reference run failed:\n"
                                 f"{proc.stderr.read()}")
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's serve steps (one subprocess, 4 forced devices),
    each case's outputs read as it finishes; the inputs go over as
    ``.npz`` files."""
    in_dir = str(tmp_path_factory.mktemp("serve_in"))
    out_dir = str(tmp_path_factory.mktemp("serve_out"))
    inputs = {}
    for tag, name, shape, B, seq, length in SERVE_CASES:
        cfg = get_config(name).reduced()
        caches, tokens = _random_caches(cfg, _shape(shape, B, seq), length,
                                        seed=24)
        inputs[tag] = (caches, tokens)
        np.savez(os.path.join(in_dir, tag + ".npz"), **_npz(caches, tokens))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, repr(SERVE_CASES), str(REF_STEPS),
         in_dir, out_dir], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    got = {}

    def result(tag):
        if tag not in got:
            got[tag] = _wait_for(proc, os.path.join(out_dir, tag + ".npz"))
        return inputs[tag], got[tag]
    try:
        yield result
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


@pytest.mark.parametrize("case", SERVE_CASES, ids=[c[0] for c in SERVE_CASES])
def test_serve_step_matches_the_reference_sharded(reference, case,
                                                  record_property):
    """``make_serve_step`` on the 2x2 mesh (``shard_params``,
    ``shard_caches`` by ``cache_specs``) against the reference's jitted
    on 4 devices, the reference's tokens and routing fed to both: logits
    within 2e-2 of their scale at every step (the hybrid's 4e-2,
    ``tests/test_torch_hybrid.py``'s bound) — or, where the reference's
    own sharded and unsharded steps (for the MoE families also its
    compiled and op-by-op steps, whose gates differ: the port computes
    the op-by-op gates) differ by more on these inputs, 1.25x that
    spread (``tests/test_torch_distribution.py``'s rule for gradients) —
    and greedy tokens equal where the reference's top-2 gap exceeds 4e-2.
    The hybrid takes each step from the reference's caches of the step
    before (its seven recurrent mixers a period carry each step's
    rounding into the next; the free run is held inside the port)."""
    tag, name, shape, B, seq, length = case
    (caches, _), ref = reference(tag)
    cfg, tp = _port_params(name)
    sh = _shape(shape, B, seq)
    mesh = make_decode_mesh(2, 2, device="cpu")
    dist = STEPS.make_dist(mesh, sh)
    sc = shard_caches(cfg, _copy(caches), STEPS.cache_specs(cfg, sh, dist),
                      mesh)
    step = STEPS.make_serve_step(cfg, dist, sh)
    sp = shard_params(cfg, tp, mesh)
    errs, spread, ties = [], [], 0
    for t in range(REF_STEPS):
        if cfg.attn_every and t:
            # the hybrid steps from the reference's own caches: each
            # step's rounding, not its recurrence's accumulation of it
            sc = shard_caches(cfg, _from_npz(caches, ref, f"caches/{t - 1}/"),
                              STEPS.cache_specs(cfg, sh, dist), mesh)._replace(
                                  length=sc.length)
        tok = torch.from_numpy(ref[f"tokens/{t}"])
        routes = [torch.from_numpy(ref[f"route/{t}/{n}"].astype(np.int64))
                  for n in range(cfg.n_layers) if f"route/{t}/{n}" in ref]
        with L.replay_routing(routes):
            logits, sc = step(sp, tok, sc)
        want = ref[f"logits/{t}"]
        got = logits.float().numpy()
        assert got.shape == want.shape
        scale = max(1.0, np.abs(want).max())
        errs.append(float(np.abs(got - want).max() / scale))
        runs = [ref[k] for k in (f"logits/{t}", f"logits1/{t}",
                                 f"logitsE/{t}") if k in ref]
        spread.append(max(float(np.abs(a - b).max() / scale)
                          for i, a in enumerate(runs) for b in runs[i + 1:]))
        top2 = np.sort(want, axis=-1)[..., -2:]
        decisive = (top2[..., 1] - top2[..., 0]) > GAP
        assert (want.argmax(-1)[decisive] == got.argmax(-1)[decisive]).all()
        ties += int((~decisive).sum())
    assert sc.length == length + REF_STEPS
    record_property("logit_err", errs)
    record_property("reference_spread", spread)
    record_property("near_ties", ties)
    base = HYBRID_TOL if cfg.attn_every else TOL
    assert max(errs) <= max(base, SPREAD * max(spread)), (errs, spread)


# ---------------------------------------------------------------------------
# inside the port: every mesh against the unsharded decode_step
# ---------------------------------------------------------------------------

def _ulp(scale: float) -> float:
    return float(2.0 ** (np.floor(np.log2(scale)) - 7))


def _bound(cfg, scale: float) -> float:
    """The in-port bound on a mesh's logits: 4 bf16 ulps of the largest;
    6 for the routed families (qwen3-moe.reduced() measured 4.08 at one
    of 16 steps on 2x2: its expert FFNs carry the attention's rounding);
    for the hybrid 8e-2 of the scale over a free run (its seven
    recurrent mixers a period carry each step's rounding into the next:
    4.5-11 ulps, up to 4.8% of the scale, measured) — one step from the
    same caches is held at 4e-2 separately."""
    if cfg.attn_every:
        return 2 * HYBRID_TOL * scale
    return (6 if cfg.moe is not None else 4) * _ulp(scale)


@pytest.mark.parametrize("dm", [(1, 4), (2, 2), (4, 1)],
                         ids=["1x4", "2x2", "4x1"])
@pytest.mark.parametrize("name", CONFIGS)
def test_serve_step_on_a_mesh_equals_the_unsharded_decode(name, dm,
                                                          record_property):
    """16 serve steps of a ``decode_32k``-like shape (4 slots, 64-slot
    caches from seed 24 at length 40) on the mesh against the unsharded
    ``decode_step`` on the same caches, both fed the unsharded stream
    and the MoE layers routed by the unsharded run (a near-tie routed the
    other way is another computation, not a rounding): logits
    within ``_bound``, argmax equal wherever the unsharded top-2 gap
    exceeds twice that; the caches gathered back within 2e-2 of the
    unsharded run's (the hybrid's 4e-2)."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sh = _shape("decode_32k", 4, 64)
    caches, tok = _random_caches(cfg, sh, 40, seed=24)
    mesh = make_decode_mesh(*dm, device="cpu")
    dist = STEPS.make_dist(mesh, sh)
    specs = STEPS.cache_specs(cfg, sh, dist)
    sc = shard_caches(cfg, _copy(caches), specs, mesh)
    sp = shard_params(cfg, params, mesh)
    step, whole = (STEPS.make_serve_step(cfg, d, sh) for d in (dist, NO_DIST))
    worst, ties, one_step = 0.0, 0, 0.0
    for t in range(PORT_STEPS):
        if cfg.attn_every and t == PORT_STEPS // 2:
            # one step of the mesh from the unsharded run's own caches
            same = shard_caches(cfg, _copy(caches), specs, mesh)
            with L.record_routing() as routes:
                lw1, _ = whole(params, tok, _copy(caches))
            with L.replay_routing(routes):
                lm1, _ = step(sp, tok, same)
            one_step = (lm1 - lw1).abs().max().item() / lw1.abs().max().item()
            assert one_step <= HYBRID_TOL, one_step
        with L.record_routing() as routes:
            lw, caches = whole(params, tok, caches)
        with L.replay_routing(routes):
            lm, sc = step(sp, tok, sc)
        scale = lw.abs().max().item()
        err = (lm - lw).abs().max().item()
        bound = _bound(cfg, scale)
        assert err <= bound, (t, err, bound)
        worst = max(worst, err / _ulp(scale))
        top2 = lw.topk(2, dim=-1).values
        decisive = (top2[..., 0] - top2[..., 1]) > 2 * bound
        assert torch.equal(lm.argmax(-1)[decisive], lw.argmax(-1)[decisive])
        ties += int((~decisive).sum())
        tok = lw.argmax(-1).to(torch.int32)
    assert sc.length == caches.length == 40 + PORT_STEPS
    for f in ("kv", "ssm"):
        for a, b in zip(getattr(sc, f) or (), getattr(caches, f) or ()):
            assert isinstance(a, Sharded)
            got = gather(a, "cpu").float()
            tol = HYBRID_TOL if cfg.attn_every else TOL
            assert (got - b.float()).abs().max().item() \
                <= tol * b.float().abs().max().item()
    record_property("worst_ulps", worst)
    record_property("near_ties", ties)
    record_property("hybrid_one_step", one_step)


@pytest.mark.parametrize("name", ["smollm-360m", "mixtral-8x7b",
                                  "mamba2-2.7b"])
def test_long_500k_ring_on_every_position(name, record_property):
    """``long_500k`` cut to 16,384 tokens on a 2x2 mesh: batch 1, so the
    ring (smollm's 8,192-slot serving window, mixtral's own 64) stripes
    over all four positions, data-major, and has wrapped; 16 steps
    against the unsharded ring decode by the same rules."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sh = _shape("long_500k", 1, 16384)
    caches, tok = _random_caches(cfg, sh, 9000, seed=25)
    mesh = make_decode_mesh(2, 2, device="cpu")
    dist = STEPS.make_dist(mesh, sh)
    specs = STEPS.cache_specs(cfg, sh, dist)
    sc = shard_caches(cfg, _copy(caches), specs, mesh)
    if sc.kv is not None:
        assert specs.kv.k[2] == ("data", "model")
        assert len(sc.kv.k.shards) == 4
    sp = shard_params(cfg, params, mesh)
    step, whole = (STEPS.make_serve_step(cfg, d, sh) for d in (dist, NO_DIST))
    worst = 0.0
    for _ in range(PORT_STEPS):
        lm, sc = step(sp, tok, sc)
        lw, caches = whole(params, tok, caches)
        scale = lw.abs().max().item()
        err = (lm - lw).abs().max().item()
        assert err <= 4 * _ulp(scale), (err, scale)
        worst = max(worst, err / _ulp(scale))
        tok = lw.argmax(-1).to(torch.int32)
    record_property("worst_ulps", worst)


def test_shard_caches_stripes_and_gathers_back():
    """``shard_caches``: a KV sequence over 'model' gives position j the
    contiguous slots [j·S/M, (j+1)·S/M) of its data row's batch slice;
    over ('data', 'model') the stripe index is data-major; every leaf
    gathers back bit for bit and an uneven split is refused."""
    cfg = get_config("jamba-1.5-large-398b").reduced()
    mesh = make_decode_mesh(2, 2, device="cpu")
    for shape, batch in (("decode_32k", 4), ("long_500k", 1)):
        sh = _shape(shape, batch, 64)
        caches, _ = _random_caches(cfg, sh, 10, seed=3)
        dist = STEPS.make_dist(mesh, sh)
        sc = shard_caches(cfg, caches, STEPS.cache_specs(cfg, sh, dist), mesh)
        k = sc.kv.k
        for key, t in k.shards.items():
            co = k.coords(key)
            if shape == "decode_32k":
                j, rows = co["model"], slice(2 * co["data"],
                                             2 * co["data"] + 2)
                want = caches.kv.k[:, rows, 32 * j:32 * (j + 1)]
            else:
                j = 2 * co["data"] + co["model"]
                want = caches.kv.k[:, :, 16 * j:16 * (j + 1)]
            assert torch.equal(t, want)
        for f in ("kv", "ssm"):
            for a, b in zip(getattr(sc, f), getattr(caches, f)):
                assert torch.equal(gather(a, "cpu"), b)
    cfg = get_config("smollm-360m").reduced()
    sh = _shape("decode_32k", 4, 65)
    caches, _ = _random_caches(cfg, sh, 1, 3)
    with pytest.raises(ValueError, match="split evenly"):
        shard_caches(cfg, caches, STEPS.cache_specs(
            cfg, sh, STEPS.make_dist(mesh, sh)), mesh)
