"""The port's forward and training on a (data, model) mesh against the
reference's distribution tests (``tests/test_distribution.py``): the
sharded MoE dispatch (expert- and tensor-parallel, several dispatch
groups, the choice of branch), the sharded ``loss_fn`` and its
gradients, the optimizers on shards, ``make_prefill_step``, and the
step module's shapes and rules.

The port runs on a CPU 2x2 mesh (``make_decode_mesh(2, 2,
device="cpu")``); the reference on 4 forced host devices, in ONE
subprocess for the whole file, started first and read when needed (its
outputs in an ``.npz``). The reference's compiled ``_route`` can route a
near-tie differently from the port (XLA keeps the bf16 router product in
fp32, ROADMAP §3), so the subprocess records each MoE call's expert ids
per mesh position (a ``jax.debug.callback`` in a wrapped ``_route``), and
the port replays them wherever it is held against the reference.

Bounds: ``moe_block``'s y within 2e-2 of its max-abs and aux within 2e-3
relative; the loss within 2e-2 relative and each gradient leaf within
2e-2 of its max-abs, or, where the reference's own sharded and unsharded
gradients of a leaf differ by more (smollm's ``final_ln``: 2.1e-2 at
this batch), 1.25x that spread; the optimizers by the rules of
``tests/test_torch_train.py``.
Measured values go into the test report (``record_property``).
"""
import dataclasses
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models.transformer as JT
from conftest import SRC
from repro.configs.base import get_config as jax_config
from repro.launch import shardings as JS
from repro.launch import steps as JSTEPS
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config, list_configs
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import Mesh, make_decode_mesh
from repro_torch.launch.shardings import (Sharded, gather, param_shapes,
                                          param_specs, shard_params)
from repro_torch.launch.steps import (loss_and_grads, make_dist,
                                      make_prefill_step, opt_state_specs)
from repro_torch.models import layers as L
from repro_torch.models.layers import NO_DIST, Dist
from repro_torch.models.transformer import prefill
from repro_torch.training.optim import make_optimizer, tree_map

torch.set_num_threads(1)

LOSS_RTOL = 2e-2
GRAD_TOL = 2e-2
Y_TOL = 2e-2
AUX_RTOL = 2e-3
SPREAD = 1.25       # times the reference's own sharded-vs-unsharded gap
MOMENT_RTOL = 2e-5

QWEN3, MIXTRAL, SMOLLM = ("qwen3-moe-235b-a22b", "mixtral-8x7b",
                          "smollm-360m")
# (tag, config, S at B = 2, MOE_GROUP_TOKENS, the branch it takes)
MOE_CASES = [
    ("ep", QWEN3, 4096, 8192, "ep"),
    ("tp", MIXTRAL, 4096, 8192, "tp"),
    ("ep_groups", QWEN3, 4096, 1024, "ep"),
    ("tp_groups", MIXTRAL, 4096, 1024, "tp"),
    ("global", QWEN3, 2048, 8192, "global"),      # T = 4096: global
    ("ep_as_tp", QWEN3, 2051, 8192, "tp"),        # T % (dp·ep) = 2: TP
]
# (tag, config, S at B = 2) of the global dispatch run from the weights'
# shards: the reference jitted with ``param_specs`` in-shardings, so XLA
# partitions its expert products where the weights lie
SPLIT_CASES = [("split_ep", QWEN3, 512), ("split_tp", MIXTRAL, 512)]
# (tag, config, B, S) of the sharded loss
LOSS_CASES = [("smollm", SMOLLM, 4, 64), ("qwen3", QWEN3, 2, 4096)]
# the routed positions, in the port's call order, of each branch
POSITIONS = {"ep": [(0, 0), (0, 1), (1, 0), (1, 1)], "tp": [(0, 0), (1, 0)],
             "global": [(-1, -1)]}

REFERENCE = r'''
import os, sys
import jax, jax.numpy as jnp, numpy as np
import repro.models.layers as L
from repro.configs.base import get_config
from repro.launch.mesh import make_test_mesh
from repro.models.transformer import init_params, loss_fn

MOE_CASES, LOSS_CASES, out_dir = eval(sys.argv[1]), eval(sys.argv[2]), sys.argv[3]
SPLIT_CASES = eval(sys.argv[4])
mesh = make_test_mesh(2, 2)
dist = L.Dist(mesh=mesh, batch_axes=("data",))
rec = {}
route = L._route


def recording(xf, w, k):
    """The reference's _route, its expert ids sent to the host with the
    calling position (-1, -1 outside shard_map)."""
    g, idx, aux = route(xf, w, k)
    try:
        d, m = jax.lax.axis_index("data"), jax.lax.axis_index("model")
    except NameError:
        d = m = jnp.int32(-1)
    jax.debug.callback(lambda i, d, m: rec.setdefault(
        (int(d), int(m)), []).append(np.asarray(i)), idx, d, m)
    return g, idx, aux


L._route = recording


def take_routes(out, tag):
    jax.effects_barrier()
    for (d, m), calls in rec.items():
        for n, i in enumerate(calls):
            out[f"{tag}/route/{d}/{m}/{n}"] = i
    rec.clear()


def save(name, out):
    np.savez(os.path.join(out_dir, name + ".tmp.npz"), **out)
    os.replace(os.path.join(out_dir, name + ".tmp.npz"),
               os.path.join(out_dir, name + ".npz"))


def tokens(name, B, S):
    cfg = get_config(name).reduced()
    rng = np.random.default_rng(5)
    return cfg, jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))


# the sharded losses first, MoE ones first: the port waits for their routing
for tag, name, B, S in sorted(LOSS_CASES,
                              key=lambda c: get_config(c[1]).moe is None):
    out = {}
    cfg, tok = tokens(name, B, S)
    p = init_params(cfg, jax.random.PRNGKey(0))
    batch = {"tokens": tok, "labels": tok}
    f = jax.value_and_grad(lambda p_, b: loss_fn(p_, b, cfg, dist))
    with mesh:
        loss, g = jax.jit(f)(p, batch)
        loss.block_until_ready()
    take_routes(out, tag)
    out[f"{tag}/loss"] = np.asarray(loss)
    for path, leaf in jax.tree_util.tree_leaves_with_path(g):
        out[f"{tag}/grad" + jax.tree_util.keystr(path)] = np.asarray(
            leaf.astype(jnp.float32))
    if cfg.moe is None:     # the reference's own sharding spread
        g0 = jax.jit(jax.grad(lambda p_, b: loss_fn(p_, b, cfg)))(p, batch)
        for path, leaf in jax.tree_util.tree_leaves_with_path(g0):
            out[f"{tag}/grad1" + jax.tree_util.keystr(path)] = np.asarray(
                leaf.astype(jnp.float32))
    save(tag, out)

out = {}
for tag, name, S, group in MOE_CASES:
    L.MOE_GROUP_TOKENS = group
    cfg = get_config(name).reduced()
    pm = jax.tree.map(lambda t: t[0], init_params(cfg, jax.random.PRNGKey(0))["moe"])
    rng = np.random.default_rng(3)
    x = jnp.asarray((rng.standard_normal((2, S, cfg.d_model)) * 0.3
                     ).astype(np.float32)).astype(jnp.bfloat16)
    with mesh:
        y, aux = jax.jit(lambda x_: L.moe_block(x_, pm, cfg, dist))(x)
        y.block_until_ready()
    take_routes(out, tag)
    out[f"{tag}/y"] = np.asarray(y.astype(jnp.float32))
    out[f"{tag}/aux"] = np.asarray(aux)
save("moe", out)

from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.shardings import param_specs
out = {}
for tag, name, S in SPLIT_CASES:
    cfg = get_config(name).reduced()
    full = init_params(cfg, jax.random.PRNGKey(0))
    pm = jax.tree.map(lambda t: t[0], full["moe"])
    specs = jax.tree.map(lambda s: NamedSharding(mesh, P(*tuple(s)[1:])),
                         param_specs(cfg, full)["moe"],
                         is_leaf=lambda s: isinstance(s, P))
    rng = np.random.default_rng(3)
    x = jnp.asarray((rng.standard_normal((2, S, cfg.d_model)) * 0.3
                     ).astype(np.float32)).astype(jnp.bfloat16)
    with mesh:
        f = jax.jit(lambda x_, p_: L.moe_block(x_, p_, cfg, dist),
                    in_shardings=(NamedSharding(mesh, P("data", None, None)),
                                  specs))
        y, aux = f(x, pm)
        y.block_until_ready()
    take_routes(out, tag)
    out[f"{tag}/y"] = np.asarray(y.astype(jnp.float32))
    out[f"{tag}/aux"] = np.asarray(aux)
save("split", out)
'''


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


def _mesh():
    return make_decode_mesh(2, 2, device="cpu")


def _dist():
    return Dist(mesh=_mesh(), batch_axes=("data",))


def _port_params(name: str):
    cfg = get_config(name).reduced()
    jp = JT.init_params(jax_config(name).reduced(), jax.random.PRNGKey(0))
    return cfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _routes(ref: dict, tag: str, branch: str, n_calls: int = 1) -> list:
    """The reference's expert ids of ``tag``, in the port's call order:
    call by call, each branch's routed positions in (data, model)
    order."""
    return [torch.from_numpy(ref[f"{tag}/route/{d}/{m}/{n}"].astype(np.int64))
            for n in range(n_calls) for d, m in POSITIONS[branch]]


def _grad_table(grads) -> dict:
    """keystr path → whole fp32 numpy gradient."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + f"[{k!r}]")
        else:
            out[path] = gather(t, "cpu").float().numpy()
    walk(grads, "")
    return out


def _distance(a: dict, b: dict) -> dict:
    return {k: float(np.abs(a[k] - b[k]).max()
                     / max(np.abs(b[k]).max(), 1e-30)) for k in b}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference's run (a subprocess, 4 forced devices) and, beside
    it, the port's sharded and unsharded loss and gradients for every
    ``LOSS_CASES`` entry under the reference's routing (the two port
    runs of a case in two threads)."""
    out_dir = str(tmp_path_factory.mktemp("distribution"))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    moe = [c[:4] for c in MOE_CASES]
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, repr(moe), repr(LOSS_CASES),
         out_dir, repr(SPLIT_CASES)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        ref, port = {}, {}
        for tag, name, B, S in LOSS_CASES:
            cfg, tp = _port_params(name)
            rng = np.random.default_rng(5)
            tok = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))
            batch = {"tokens": tok, "labels": tok}
            sharded = []
            if cfg.moe is not None:
                ref.update(_wait_for(proc, os.path.join(out_dir,
                                                        tag + ".npz")))
                sharded = _routes(ref, tag, "ep", cfg.n_layers)
            # the unsharded call of a layer routes its positions' rows
            whole = [torch.cat(sharded[i:i + 4])
                     for i in range(0, len(sharded), 4)]
            got = {}

            def run(key, params, dist, routes):
                with L.replay_routing(routes):
                    got[key] = loss_and_grads(params, batch, cfg, dist)

            th = threading.Thread(target=run, args=("whole", tp, NO_DIST,
                                                    whole))
            th.start()
            try:
                run("sharded", shard_params(cfg, tp, _mesh()), _dist(),
                    sharded)
            finally:
                th.join()
            port[tag] = {k: (float(v[0]), _grad_table(v[1]))
                         for k, v in got.items()}
        for name in [c[0] for c in LOSS_CASES] + ["moe", "split"]:
            ref.update(_wait_for(proc, os.path.join(out_dir,
                                                    name + ".npz")))
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    return ref, port


# ---------------------------------------------------------------------------
# the sharded MoE dispatch
# ---------------------------------------------------------------------------

def _moe_input(cfg, S: int):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, S, cfg.d_model)) * 0.3).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_block_matches_the_reference_sharded(results, case, monkeypatch,
                                                 record_property):
    """``moe_block`` on the 2x2 mesh against the reference's
    ``shard_map`` dispatch on 4 devices, same weights, input and routing:
    the branch the reference's rule picks, y within 2e-2 of its max-abs,
    aux within 2e-3 relative."""
    ref, _ = results
    tag, name, S, group, branch = case
    monkeypatch.setattr(L, "MOE_GROUP_TOKENS", group)
    cfg, tp = _port_params(name)
    pm = {k: v[0] for k, v in tp["moe"].items()}
    with L.record_moe_branches() as taken, \
            L.replay_routing(_routes(ref, tag, branch)):
        y, aux = L.moe_block(_moe_input(cfg, S), pm, cfg, _dist())
    assert taken == [branch]
    ry, raux = ref[f"{tag}/y"], float(ref[f"{tag}/aux"])
    y_err = float(np.abs(y.float().numpy() - ry).max() / np.abs(ry).max())
    aux_err = abs(float(aux) - raux) / abs(raux)
    record_property("y_err", y_err)
    record_property("aux_err", aux_err)
    assert y.shape == (2, S, cfg.d_model) and y.dtype == torch.bfloat16
    assert y_err <= Y_TOL and aux_err <= AUX_RTOL, (y_err, aux_err)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_global_dispatch_split_matches_the_reference_sharded(
        results, case, record_property):
    """The global dispatch (2 x 512 tokens) from ``shard_params``'
    slices, split where the weights lie — fp32 partials summed over
    'data' (and, "tp", over 'model') and rounded once — against the
    reference's jitted ``moe_block`` with ``param_specs`` in-shardings
    on 4 devices, whose expert products XLA partitions the same way,
    under the reference's routing: y within 2 bf16 ulps of its largest
    (the share of outputs that differ is recorded), aux within 2e-3
    relative, for "ep" (qwen3-moe) and "tp" (mixtral)."""
    ref, _ = results
    tag, name, S = case
    cfg, tp = _port_params(name)
    sp = shard_params(cfg, tp, _mesh())
    pm = {k: v[0] for k, v in sp["moe"].items()}
    with L.record_moe_branches() as taken, \
            L.replay_routing(_routes(ref, tag, "global")):
        y, aux = L.moe_block(_moe_input(cfg, S), pm, cfg, _dist())
    assert taken == ["global"]
    ry, raux = ref[f"{tag}/y"], float(ref[f"{tag}/aux"])
    scale = float(np.abs(ry).max())
    ulp = float(2.0 ** (np.floor(np.log2(scale)) - 7))
    got = y.float().numpy()
    err = float(np.abs(got - ry).max())
    record_property("ulps", err / ulp)
    record_property("differ", float((got != ry).mean()))
    assert err <= 2 * ulp, err / ulp
    assert abs(float(aux) - raux) <= AUX_RTOL * abs(raux)


@pytest.mark.parametrize("case", MOE_CASES[:2], ids=["ep", "tp"])
def test_moe_block_sharded_leaves_equal_whole_leaves(case):
    """The same dispatch from ``shard_params``' slices as from whole
    leaves: bit for bit (a gather is a copy)."""
    tag, name, S, _, _ = case
    cfg, tp = _port_params(name)
    mesh = _mesh()
    sp = shard_params(cfg, tp, mesh)
    x = _moe_input(cfg, S)
    dist = Dist(mesh=mesh, batch_axes=("data",))
    a = L.moe_block(x, {k: v[0] for k, v in tp["moe"].items()}, cfg, dist)
    b = L.moe_block(x, {k: v[0] for k, v in sp["moe"].items()}, cfg, dist)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("case", MOE_CASES[:4],
                         ids=[c[0] for c in MOE_CASES[:4]])
def test_moe_block_equals_its_per_position_oracle(case, monkeypatch):
    """Each position's output is ``_moe_dispatch_compute`` of its own
    token slice, group by group, at the local capacity (EP: bit for bit;
    TP, the data slice with every expert: within 4 bf16 ulps of the
    largest output — the partial sums' rounding — phase 17's rule on the
    card); aux is the positions' mean."""
    tag, name, S, group, branch = case
    monkeypatch.setattr(L, "MOE_GROUP_TOKENS", group)
    cfg, tp = _port_params(name)
    pm = {k: v[0] for k, v in tp["moe"].items()}
    x = _moe_input(cfg, S)
    y, aux = L.moe_block(x, pm, cfg, _dist())
    h = L.rms_norm(x, pm["ln"], cfg.norm_eps).reshape(-1, cfg.d_model)
    n = 4 if branch == "ep" else 2
    T_loc = h.shape[0] // n
    groups = max(T_loc // group, 1)
    G = T_loc // groups
    cap = L.moe_capacity(cfg, G)
    ys, auxes = [], []
    for i in range(n):
        local = h[i * T_loc:(i + 1) * T_loc]
        for g in range(groups):
            ys.append(L._moe_dispatch_compute(
                local[g * G:(g + 1) * G], pm["router"], pm["w1"], pm["w2"],
                pm["w3"], cfg.moe.top_k, cap)[0])
        auxes.append(L._route(local, pm["router"], cfg.moe.top_k)[2])
    want = torch.cat(ys).view(x.shape)
    if branch == "ep":
        assert torch.equal(y, want)
    else:
        scale = want.abs().max().item()
        assert (y.float() - want.float()).abs().max().item() \
            <= 4 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert torch.allclose(aux, sum(auxes) / n, rtol=1e-6)


def test_moe_shard_map_matches_global_dispatch():
    """The reference's own property (``tests/test_distribution.py:83``)
    inside the port: the expert-parallel dispatch on the 2x2 mesh
    against the single-device dispatch, more than 98% of outputs within
    0.05 (group capacities differ from the global one)."""
    cfg, tp = _port_params(QWEN3)
    pm = {k: v[0] for k, v in tp["moe"].items()}
    x = _moe_input(cfg, 4096)
    y0, _ = L.moe_block(x, pm, cfg, NO_DIST)
    with L.record_moe_branches() as taken:
        y1, _ = L.moe_block(x, pm, cfg, _dist())
    assert taken == ["ep"]
    close = ((y0.float() - y1.float()).abs() < 0.05).float().mean().item()
    assert close > 0.98, close


def test_moe_branch_follows_the_threshold_read_at_call_time(monkeypatch):
    """``MOE_GLOBAL_DISPATCH_MAX_TOKENS`` is read at call time: 256
    tokens take the global dispatch, and with the threshold lowered
    below them the expert-parallel one; without a mesh there is no
    branch to take."""
    cfg, tp = _port_params(QWEN3)
    pm = {k: v[0] for k, v in tp["moe"].items()}
    x = _moe_input(cfg, 128)
    with L.record_moe_branches() as taken:
        L.moe_block(x, pm, cfg, _dist())
        monkeypatch.setattr(L, "MOE_GLOBAL_DISPATCH_MAX_TOKENS", 64)
        L.moe_block(x, pm, cfg, _dist())
        L.moe_block(x, pm, cfg)
    assert taken == ["global", "ep"]


# ---------------------------------------------------------------------------
# the sharded loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_sharded_loss_and_grads_match_the_reference(results, case,
                                                    record_property):
    """``loss_fn`` on the 2x2 mesh (the reference's
    ``test_sharded_train_step_matches_single_device``, gradients too)
    against the reference's sharded run: the loss within 2e-2 relative,
    each gradient leaf within 2e-2 of its max-abs or 1.25x the
    reference's own sharded-vs-unsharded spread of that leaf."""
    ref, port = results
    tag = case[0]
    loss, grads = port[tag]["sharded"]
    rloss = float(ref[f"{tag}/loss"])
    rgrads = {k[len(f"{tag}/grad"):]: v for k, v in ref.items()
              if k.startswith(f"{tag}/grad[")}
    assert grads.keys() == rgrads.keys()
    spread = {}
    if f"{tag}/grad1['embed']" in ref:
        spread = _distance(rgrads, {k: ref[f"{tag}/grad1" + k]
                                    for k in rgrads})
    dist = _distance(grads, rgrads)
    record_property("loss", (loss, rloss))
    record_property("grad_distance", dist)
    record_property("reference_spread", spread)
    assert abs(loss - rloss) <= LOSS_RTOL * abs(rloss), (loss, rloss)
    for k, d in dist.items():
        assert d <= max(GRAD_TOL, SPREAD * spread.get(k, 0.0)), (k, d)


@pytest.mark.parametrize("case", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_sharded_loss_and_grads_match_the_unsharded_port(results, case,
                                                         record_property):
    """The same against the port's own unsharded ``loss_fn`` under the
    same routing: the loss within 2e-2 relative, each gradient leaf
    within 2e-2 of its max-abs, the sharded gradients sharded like the
    params."""
    _, port = results
    loss, grads = port[case[0]]["sharded"]
    loss0, grads0 = port[case[0]]["whole"]
    dist = _distance(grads, grads0)
    record_property("grad_distance", dist)
    assert abs(loss - loss0) <= LOSS_RTOL * abs(loss0), (loss, loss0)
    assert max(dist.values()) <= GRAD_TOL, max(dist.items(),
                                               key=lambda kv: kv[1])


def test_sharded_gradients_live_on_their_shards():
    cfg, tp = _port_params(SMOLLM)
    sp = shard_params(cfg, tp, _mesh())
    tok = torch.zeros((2, 16), dtype=torch.int64)
    _, grads = loss_and_grads(sp, {"tokens": tok, "labels": tok}, cfg,
                              _dist())
    g, p = grads["attn"]["wq"], sp["attn"]["wq"]
    assert isinstance(g, Sharded) and g.spec == p.spec
    assert {k: t.shape for k, t in g.shards.items()} \
        == {k: t.shape for k, t in p.shards.items()}


# ---------------------------------------------------------------------------
# the optimizers on shards
# ---------------------------------------------------------------------------

def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _pairs(a, b, path=""):
    """(path, port-sharded as numpy, whole as numpy) over matching trees
    (dicts, factored (row, col) tuples)."""
    if isinstance(b, dict):
        for k in b:
            yield from _pairs(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}[{i}]")
    else:
        yield (path, gather(a, "cpu").float().numpy(),
               b.float().numpy())


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_sharded_optimizer_step_equals_the_unsharded(name):
    """Two updates of each optimizer on the 2x2 mesh's shards against
    the same updates of whole leaves, fed the same gradients: fp32
    moments within 2e-5 relative (Adafactor's bf16 first moment within
    one bf16 ulp, or 2e-5 of the leaf's max-abs), params within one bf16
    ulp — ``tests/test_torch_train.py``'s rules. Adafactor's row and
    column means, the mean of the row mean and the RMS clip reduce across
    shards. As in that file's test, the second update starts both sides
    from the unsharded first one's params and state (resharded bit for
    bit)."""
    cfg, tp = _port_params(SMOLLM)
    cfg = dataclasses.replace(cfg, optimizer=name)
    mesh = _mesh()
    sp = shard_params(cfg, tp, mesh)
    init, update = make_optimizer(name)
    st, sst = init(tp), init(sp)
    for seed in (0, 1):
        if seed:
            sp, sst = _reshard(tp, sp), _reshard(st, sst)
        rng = np.random.default_rng(seed)
        grads = tree_map(lambda p: torch.from_numpy(rng.standard_normal(
            p.shape).astype(np.float32) * 1e-2).to(p.dtype), tp)
        tp, st = update(tp, grads, st)
        sp, sst = update(sp, _reshard(grads, sp), sst)
        assert int(sst.step) == int(st.step) == seed + 1
        for path, a, b in _pairs(sp, tp):
            assert (np.abs(a - b) <= _bf16_ulp(b)).all(), path
        for tree, whole, bf16 in ((sst.m, st.m, name == "adafactor"),
                                  (sst.v, st.v, False)):
            for path, a, b in _pairs(tree, whole):
                bound = MOMENT_RTOL * np.abs(b)
                if bf16:
                    bound = np.maximum(bound, np.maximum(
                        _bf16_ulp(b), MOMENT_RTOL * np.abs(b).max()))
                assert (np.abs(a - b) <= bound).all(), (
                    path, np.abs(a - b).max())


def _reshard(whole, like):
    """``whole`` (params or optimizer state of whole leaves) split the
    way the sharded ``like`` is."""
    if isinstance(like, Sharded):
        return like.like(whole)
    if isinstance(like, dict):
        return {k: _reshard(whole[k], v) for k, v in like.items()}
    if isinstance(like, tuple):
        return type(like)(*(_reshard(w, v) for w, v in zip(whole, like))) \
            if hasattr(like, "_fields") else tuple(
                _reshard(w, v) for w, v in zip(whole, like))
    return whole.clone()


def test_adafactor_state_is_sharded_like_the_reference_specs():
    """A sharded Adafactor state's specs are ``opt_state_specs``': m
    follows the parameter, the factored v drops the last or
    second-to-last axis."""
    cfg, tp = _port_params(SMOLLM)
    sp = shard_params(cfg, tp, _mesh())
    init, _ = make_optimizer("adafactor")
    st = init(sp)
    specs = opt_state_specs(dataclasses.replace(cfg, optimizer="adafactor"),
                            param_specs(cfg, tp), tp)
    pad = lambda s, n: tuple(s) + (None,) * (n - len(s))
    for k in ("embed", "final_ln"):
        assert st.m[k].spec == pad(specs.m[k], st.m[k].ndim)
    vr, vc = st.v["attn"]["wq"]
    assert (vr.spec, vc.spec) == specs.v["attn"]["wq"]
    assert st.v["final_ln"].spec == pad(specs.v["final_ln"], 1)


# ---------------------------------------------------------------------------
# steps: prefill, the shapes, make_dist, opt_state_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [SMOLLM, QWEN3, MIXTRAL, "mamba2-2.7b",
                                  "jamba-1.5-large-398b", "whisper-large-v3",
                                  "internvl2-26b"])
def test_make_prefill_step_matches_the_unsharded_prefill(name):
    """``make_prefill_step`` on the 2x2 mesh against the unsharded
    ``prefill``, the MoE layers under the unsharded run's routing:
    last-position logits within 2e-2 of their scale (jamba's hybrid at
    4e-2, ``tests/test_torch_hybrid.py``'s bound: its reduced stack
    amplifies rounding), the KV of every layer — its stripes gathered —
    within the same of its scale, the length equal."""
    cfg, tp = _port_params(name)
    rng = np.random.default_rng(7)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 48)))
    extra = {}
    if cfg.encoder_layers:
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "patch":
        extra["patches"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    with L.record_routing() as routes:
        ref, rc = prefill(tp, tok, cfg, **extra)
    step = make_prefill_step(cfg, _dist())
    with L.replay_routing(routes):      # 192 tokens: the global dispatch
        logits, caches = step(shard_params(cfg, tp, _mesh()), tok, extra)
    tol = 4e-2 if cfg.attn_every else 2e-2
    scale = ref.abs().max().item()
    assert logits.shape == ref.shape and caches.length == rc.length
    assert (logits - ref).abs().max().item() <= tol * scale
    if rc.kv is not None:
        for a, b in ((caches.kv.k, rc.kv.k), (caches.kv.v, rc.kv.v)):
            a = gather(a, "cpu")
            assert a.shape == b.shape
            assert (a.float() - b.float()).abs().max().item() \
                <= tol * b.float().abs().max().item()
    if rc.ssm is not None:
        assert caches.ssm.ssm.shape == rc.ssm.ssm.shape


def test_make_prefill_step_on_a_1x1_mesh_is_the_unsharded_prefill():
    """One position: no partial sums, no split — bit for bit."""
    cfg, tp = _port_params(SMOLLM)
    mesh = make_decode_mesh(1, 1, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 40)))
    logits, caches = make_prefill_step(cfg, Dist(mesh=mesh))(
        shard_params(cfg, tp, mesh), tok, {})
    ref, rc = prefill(tp, tok, cfg)
    assert torch.equal(logits, ref) \
        and torch.equal(gather(caches.kv.k, "cpu"), rc.kv.k)


def test_decode_on_a_mesh_is_not_distributed():
    """Decode on a mesh is the context-parallel serve step now: the
    stack's decode mode no longer refuses a mesh, and ``decode_step``
    over ``shard_caches``' stripes matches the unsharded step on the
    same caches within 4 bf16 ulps of the largest logit."""
    from repro_torch.launch.shardings import shard_caches
    from repro_torch.models.transformer import decode_step, init_caches
    cfg, tp = _port_params(SMOLLM)
    mesh = _mesh()
    caches = init_caches(cfg, 2, 16, device="cpu")._replace(length=3)
    shape = dataclasses.replace(STEPS.INPUT_SHAPES["decode_32k"], batch=2,
                                seq=16)
    dist = make_dist(mesh, shape)
    sc = shard_caches(cfg, caches, STEPS.cache_specs(cfg, shape, dist), mesh)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    with torch.no_grad():
        lm, cm = decode_step(shard_params(cfg, tp, mesh), tok, sc, cfg, dist)
        lw, cw = decode_step(tp, tok, caches, cfg)
    assert lm.shape == lw.shape == (2, 1, cfg.padded_vocab)
    assert cm.length == cw.length == 4
    scale = lw.abs().max().item()
    assert (lm - lw).abs().max().item() \
        <= 4 * 2.0 ** (np.floor(np.log2(scale)) - 7)


def test_input_shapes_and_rules_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in STEPS.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in JSTEPS.INPUT_SHAPES.items()}
    assert STEPS.SERVE_WINDOW == JSTEPS.SERVE_WINDOW
    for name in list_configs():
        for shape in STEPS.INPUT_SHAPES:
            a, b = get_config(name), jax_config(name)
            sa, sb = STEPS.INPUT_SHAPES[shape], JSTEPS.INPUT_SHAPES[shape]
            assert STEPS.applicability(a, sa) == JSTEPS.applicability(b, sb)
            assert STEPS.serve_window(a, sa) == JSTEPS.serve_window(b, sb)


@pytest.mark.parametrize("shape", ["train_4k", "long_500k"])
def test_make_dist_batch_rule(shape):
    """``make_dist``: the mesh's pod and data axes carry the batch,
    none for a batch of one; the rows of the device grid follow."""
    import numpy as np_
    devs = np_.asarray([torch.device("cpu")] * 8, dtype=object).reshape(
        2, 2, 2)
    mesh = Mesh(devs, ("pod", "data", "model"))
    dist = make_dist(mesh, STEPS.INPUT_SHAPES[shape])
    if shape == "long_500k":
        assert dist.batch_axes == () and dist.grid().shape == (1, 2)
    else:
        assert dist.batch_axes == ("pod", "data")
        assert dist.grid().shape == (4, 2)
    assert dist.axis_size(("pod", "data")) == 4 and dist.axis_size("model") == 2
    assert not NO_DIST.active and NO_DIST.axis_size("model") == 1


@pytest.mark.parametrize("name", list_configs())
def test_opt_state_specs_equal_the_reference(name):
    jcfg, cfg = jax_config(name), get_config(name)
    jshapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    ref = JSTEPS.opt_state_specs(jcfg, JS.param_specs(jcfg, jshapes),
                                 jshapes)
    shapes = param_shapes(cfg)
    got = opt_state_specs(cfg, param_specs(cfg, shapes), shapes)
    is_spec = lambda s: isinstance(s, P)

    def table(tree, leaf):
        return {jax.tree_util.keystr(p): leaf(s) for p, s in
                jax.tree_util.tree_leaves_with_path(
                    tree, is_leaf=lambda s: is_spec(s) or (
                        isinstance(s, tuple) and all(
                            x is None or isinstance(x, str) for x in s)))}
    assert tuple(got.step) == tuple(ref.step)
    for field in ("m", "v"):
        want = table(getattr(ref, field), tuple)
        mine = table(getattr(got, field), tuple)
        assert mine == want, field
