"""The tensor-parallel Mamba2 mixer (``mamba_block(dist=)``) and the
vocab-parallel embedding, unembedding and cross-entropy on a (data,
model) mesh of CPU positions, against the reference's sharded runs and
against the port's own unsharded ones.

The reference runs in ONE subprocess on 4 forced host devices (2x2,
``make_test_mesh``), started first: its ``mamba_block`` jitted with
``param_specs`` shardings and the state laid out by ``cache_specs`` —
a prefill of 4 x 64 tokens and a one-token decode from a state — for
mamba2's and jamba's mixers, and ``loss_fn`` with its gradients on the
mesh for mamba2 (tied embedding, every layer a mixer) and llama2
(``lm_head``), with its own unsharded gradients beside them.

Bounds: the mixer's y and new state within 2e-2 of their max-abs; the
loss within 2e-2 relative and each gradient leaf within 2e-2 of its
max-abs (mamba2's 3e-2, ``tests/test_torch_train_parity.py``'s
``WIDER``) or 1.25x the reference's own sharded-vs-unsharded spread of
that leaf (``tests/test_torch_distribution.py``'s rules). Inside the
port the mixer's conv state is bit for bit the unsharded one and its
SSM state within 1e-6 relative (the heads are independent), y within 1
bf16 ulp of its max-abs; the embedding is bit for bit, the logits
within 1 ulp, the cross-entropy's loss within 1e-6 relative and its
bf16 gradient within 1 ulp.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from conftest import SRC
from test_torch_train_parity import WIDER
from repro.configs.base import get_config as jax_config
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import make_decode_mesh
from repro_torch.launch.shardings import Sharded, gather, shard_params
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import mamba as MB
from repro_torch.models import transformer as T
from repro_torch.models.layers import NO_DIST, Dist, split_rows
from repro_torch.models.mamba import MambaState, mamba_block

torch.set_num_threads(1)

TOL = 2e-2
SPREAD = 1.25
MAMBA2, JAMBA, LLAMA = "mamba2-2.7b", "jamba-1.5-large-398b", "llama2-70b"
MIXERS = [MAMBA2, JAMBA]
LOSS_CASES = [MAMBA2, LLAMA]
B, S = 4, 64

REFERENCE = r'''
import os, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.launch.mesh import make_test_mesh
from repro.launch.shardings import param_specs
from repro.models.layers import Dist
from repro.models.mamba import MambaState, mamba_block
from repro.models.transformer import init_params, loss_fn

MIXERS, LOSS_CASES, in_dir, out_dir = (eval(sys.argv[1]), eval(sys.argv[2]),
                                       sys.argv[3], sys.argv[4])
mesh = make_test_mesh(2, 2)
dist = Dist(mesh=mesh, batch_axes=("data",))
named = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                                  is_leaf=lambda s: isinstance(s, P))


def save(name, out):
    np.savez(os.path.join(out_dir, name + ".tmp.npz"), **out)
    os.replace(os.path.join(out_dir, name + ".tmp.npz"),
               os.path.join(out_dir, name + ".npz"))


for name in MIXERS:
    cfg = get_config(name).reduced()
    params = init_params(cfg, jax.random.PRNGKey(0))
    d = dict(np.load(os.path.join(in_dir, "mixer-" + name + ".npz")))
    lead = 2 if cfg.attn_every else 1

    def layer(p):
        return jax.tree.map(lambda t: t[(0,) * lead], p["mamba"])
    st_spec = MambaState(ssm=P("data", "model", None, None),
                         conv=P("data", None, "model"))
    out = {}
    for tag, x, st in (("prefill", d["x_prefill"], None),
                       ("decode", d["x_decode"], MambaState(
                           jnp.asarray(d["ssm"]),
                           jnp.asarray(d["conv"]).astype(jnp.bfloat16)))):
        x = jnp.asarray(x).astype(jnp.bfloat16)
        f = jax.jit(lambda p, x_, s_: mamba_block(
            x_, layer(p), cfg, dist, state=s_, return_state=True),
            in_shardings=(named(param_specs(cfg, params)),
                          NamedSharding(mesh, P("data", None, None)),
                          None if st is None else named(st_spec)))
        with mesh:
            y, new = f(params, x, st)
        out[f"{tag}/y"] = np.asarray(y.astype(jnp.float32))
        out[f"{tag}/ssm"] = np.asarray(new.ssm)
        out[f"{tag}/conv"] = np.asarray(new.conv.astype(jnp.float32))
    save("mixer-" + name, out)

for name in LOSS_CASES:
    cfg = get_config(name).reduced()
    params = init_params(cfg, jax.random.PRNGKey(0))
    tok = jnp.asarray(np.load(os.path.join(in_dir, "tokens.npy")))
    batch = {"tokens": tok, "labels": tok}
    f = jax.value_and_grad(lambda p_, b: loss_fn(p_, b, cfg, dist))
    with mesh:
        loss, g = jax.jit(f, in_shardings=(named(param_specs(cfg, params)),
                                           None))(params, batch)
    g0 = jax.jit(jax.grad(lambda p_, b: loss_fn(p_, b, cfg)))(params, batch)
    out = {"loss": np.asarray(loss)}
    for tag, tree in (("grad", g), ("grad1", g0)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            out[tag + jax.tree_util.keystr(path)] = np.asarray(
                leaf.astype(jnp.float32))
    save("loss-" + name, out)
'''


def _port_params(name: str):
    cfg = get_config(name).reduced()
    jp = JT.init_params(jax_config(name).reduced(), jax.random.PRNGKey(0))
    return cfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, seed: int = 11) -> dict:
    """x for a 4 x 64 prefill and a one-token decode, and the decode's
    state: bf16 N(0, 1) inputs and conv state, an fp32 N(0, 0.3²) SSM
    state, all rounded to what both packages hold."""
    rng = np.random.default_rng(seed)
    s, D = cfg.ssm, cfg.d_model
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16() \
        .float().numpy()
    return {"x_prefill": bf(rng.standard_normal((B, S, D))),
            "x_decode": bf(rng.standard_normal((B, 1, D))),
            "ssm": (0.3 * rng.standard_normal(
                (B, s.n_heads(D), s.head_dim, s.d_state))).astype(np.float32),
            "conv": bf(rng.standard_normal(
                (B, s.d_conv - 1, s.conv_channels(D))))}


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


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
    in_dir = str(tmp_path_factory.mktemp("tp_in"))
    out_dir = str(tmp_path_factory.mktemp("tp_out"))
    for name in MIXERS:
        np.savez(os.path.join(in_dir, f"mixer-{name}.npz"),
                 **_inputs(get_config(name).reduced()))
    np.save(os.path.join(in_dir, "tokens.npy"),
            _tokens(get_config(LLAMA).reduced()))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, repr(MIXERS), repr(LOSS_CASES),
         in_dir, out_dir], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    got = {}

    def result(name):
        if name not in got:
            got[name] = _wait_for(proc, os.path.join(out_dir, name + ".npz"))
        return got[name]
    try:
        yield result
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def _mesh():
    return make_decode_mesh(2, 2, device="cpu")


def _dist(mesh=None):
    return Dist(mesh=mesh or _mesh(), batch_axes=("data",))


def _layer(cfg, params):
    lead = 2 if cfg.attn_every else 1
    return {k: v[(0,) * lead] if not isinstance(v, Sharded) else
            (v[0][0] if lead == 2 else v[0]) for k, v in params.items()}


def _state(d: dict) -> MambaState:
    return MambaState(ssm=torch.from_numpy(d["ssm"]),
                      conv=torch.from_numpy(d["conv"]).bfloat16())


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("name", MIXERS)
def test_mixer_matches_the_reference_sharded(reference, name, mode,
                                             record_property):
    """``mamba_block`` on the 2x2 mesh from ``shard_params``' slices
    against the reference's jitted on 4 devices: y and the new SSM and
    conv states within 2e-2 of their max-abs; the state ``Sharded`` by
    ``cache_specs``' layout."""
    ref = reference("mixer-" + name)
    cfg, tp = _port_params(name)
    d = _inputs(cfg)
    mesh = _mesh()
    p = _layer(cfg, shard_params(cfg, tp, mesh)["mamba"])
    x = torch.from_numpy(d[f"x_{mode}"]).bfloat16()
    st = _state(d) if mode == "decode" else None
    y, new = mamba_block(x, p, cfg, _dist(mesh), state=st, return_state=True)
    assert isinstance(new.ssm, Sharded)
    assert new.ssm.spec == ("data", "model", None, None)
    assert new.conv.spec == ("data", None, "model")
    errs = {"y": _rel(y.float().numpy(), ref[f"{mode}/y"]),
            "ssm": _rel(gather(new.ssm, "cpu").numpy(), ref[f"{mode}/ssm"]),
            "conv": _rel(gather(new.conv, "cpu").float().numpy(),
                         ref[f"{mode}/conv"])}
    record_property("errors", errs)
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("dm", [(1, 4), (2, 2), (4, 1)],
                         ids=["1x4", "2x2", "4x1"])
@pytest.mark.parametrize("name", MIXERS)
def test_mixer_on_a_mesh_equals_the_unsharded_mixer(name, dm, mode,
                                                    monkeypatch):
    """Inside the port: the new conv state bit for bit, the SSM state
    within 1e-6 relative, y within 1 bf16 ulp of its max-abs; the scan
    runs once per (row, position), each on nh / M heads, through the
    kernel op (its plain version on these CPU tensors)."""
    cfg = get_config(name).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_decode_mesh(*dm, device="cpu")
    d = _inputs(cfg, seed=12)
    x = torch.from_numpy(d[f"x_{mode}"]).bfloat16()
    st = _state(d) if mode == "decode" else None
    whole = _layer(cfg, params["mamba"])
    y0, n0 = mamba_block(x, whole, cfg, state=st, return_state=True)
    calls = []
    op = MB.ssd_scan_op

    def counting(xh, *a, **k):
        calls.append(tuple(xh.shape))
        return op(xh, *a, **k)
    monkeypatch.setattr(MB, "ssd_scan_op", counting)
    y1, n1 = mamba_block(x, _layer(cfg, shard_params(cfg, params,
                                                     mesh)["mamba"]),
                         cfg, _dist(mesh), state=st, return_state=True)
    nh = cfg.ssm.n_heads(cfg.d_model)
    if mode == "prefill":
        assert calls == [(B // dm[0], S, nh // dm[1], cfg.ssm.head_dim)] \
            * (dm[0] * dm[1])
    else:
        assert calls == []                 # one token: ssd_decode
    assert torch.equal(gather(n1.conv, "cpu"), n0.conv)
    assert _rel(gather(n1.ssm, "cpu").numpy(), n0.ssm.numpy()) <= 1e-6
    scale = y0.float().abs().max().item()
    assert (y1.float() - y0.float()).abs().max().item() \
        <= 2.0 ** (np.floor(np.log2(scale)) - 7)


def test_mixer_refuses_heads_that_do_not_split():
    """Three model positions over 32 heads: refused, no other layout."""
    cfg = get_config(MAMBA2).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_decode_mesh(1, 3, device="cpu")
    x = torch.zeros((2, 4, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not split over 3"):
        mamba_block(x, _layer(cfg, params["mamba"]), cfg, _dist(mesh))


def test_ssm_stack_state_stays_sharded_in_decode():
    """``decode_step`` on the mesh continues from ``Sharded`` states and
    returns them ``Sharded`` the same way; a prefill's come back whole."""
    from repro_torch.launch.shardings import shard_caches
    from repro_torch.launch.steps import INPUT_SHAPES, cache_specs, make_dist
    cfg = get_config(MAMBA2).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = _mesh()
    tok = torch.from_numpy(_tokens(cfg)[:, :16])
    dist = _dist(mesh)
    sp = shard_params(cfg, params, mesh)
    with torch.no_grad():
        _, c = T.prefill(sp, tok, cfg, dist)
        assert isinstance(c.ssm.ssm, torch.Tensor)
        sh = dataclasses.replace(INPUT_SHAPES["decode_32k"], batch=B, seq=64)
        sc = shard_caches(cfg, c, cache_specs(cfg, sh, make_dist(mesh, sh)),
                          mesh)
        l1, c1 = T.decode_step(sp, tok[:, :1], sc, cfg, dist)
        l0, c0 = T.decode_step(params, tok[:, :1], c, cfg)
    assert isinstance(c1.ssm.ssm, Sharded) and c1.ssm.ssm.spec == \
        sc.ssm.ssm.spec and c1.length == c0.length == 17
    assert _rel(gather(c1.ssm.ssm, "cpu").numpy(), c0.ssm.ssm.numpy()) \
        <= TOL
    assert (l1 - l0).abs().max().item() <= TOL * l0.abs().max().item()


# ---------------------------------------------------------------------------
# vocab-parallel embedding, unembedding and cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["smollm-360m", LLAMA])
def test_vocab_parallel_embedding_and_logits(name):
    """The lookup bit for bit (one nonzero part per id), the logits
    stripes concatenated within 1 bf16 ulp of the whole unembedding's,
    for a tied and an untied config."""
    cfg = get_config(name).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for dm in ((1, 4), (2, 2)):
        mesh = make_decode_mesh(*dm, device="cpu")
        dist = _dist(mesh)
        sp = shard_params(cfg, params, mesh)
        tok = torch.from_numpy(_tokens(cfg))
        tok[0, :4] = torch.tensor([0, cfg.padded_vocab - 1,
                                   cfg.padded_vocab // 4,
                                   cfg.padded_vocab // 4 - 1])
        rows = T._embed(sp, tok, cfg, dist)
        assert torch.equal(torch.cat(rows), T._embed(params, tok, cfg))
        h = torch.cat(rows)[:, :8]
        whole = T._logits_at(params, h, cfg)
        grid = dist.grid()
        got = torch.cat([T._logits_at(sp, hr, cfg, grid[r]) for r, hr in
                         enumerate(split_rows(h, dist))])
        scale = whole.abs().max().item()
        assert got.shape == (B, 8, cfg.padded_vocab)
        assert (got - whole).abs().max().item() \
            <= 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("name", ["smollm-360m", LLAMA])
def test_vocab_parallel_cross_entropy(name, monkeypatch):
    """``_ce_sums`` over a row's 4 vocabulary stripes against the whole
    unembedding's, several ``CE_CHUNK`` slices and masked labels: the
    summed loss within 1e-6 relative, the count equal, the bf16 gradient
    with respect to h within 1 bf16 ulp of its max-abs (the stripes'
    backward products are summed in another order)."""
    monkeypatch.setattr(T, "CE_CHUNK", 16)
    cfg = get_config(name).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_decode_mesh(1, 4, device="cpu")
    sp = shard_params(cfg, params, mesh)
    rng = np.random.default_rng(3)
    h0 = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model))
                          .astype(np.float32)).bfloat16()
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    labels[0, :5] = -1
    labels[1, :3] = torch.tensor([0, cfg.padded_vocab - 1,
                                  cfg.padded_vocab // 4])
    out = []
    for p, devices in ((params, None), (sp, _dist(mesh).grid()[0])):
        h = h0.clone().requires_grad_(True)
        tot, cnt = T._ce_sums(p, h, labels, cfg, devices)
        (g,) = torch.autograd.grad(tot, h)
        out.append((tot.item(), cnt.item(), g.float()))
    (t0, c0, g0), (t1, c1, g1) = out
    assert c0 == c1 == 2 * 64 - 5
    assert abs(t1 - t0) <= 1e-6 * abs(t0)
    assert (g1 - g0).abs().max().item() \
        <= 2.0 ** (np.floor(np.log2(g0.abs().max().item())) - 7)


def _grad_table(grads) -> dict:
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + f"[{k!r}]")
        else:
            out[path] = gather(t, "cpu").float().numpy()
    walk(grads, "")
    return out


@pytest.mark.parametrize("name", LOSS_CASES)
def test_sharded_loss_matches_the_reference(reference, name,
                                            record_property):
    """``loss_fn`` and its gradients on the 2x2 mesh — the
    tensor-parallel mixers (mamba2) and the vocab-parallel embedding and
    cross-entropy (mamba2 tied, llama2 through ``lm_head``) — against
    the reference's sharded run: the loss within 2e-2 relative, each
    gradient leaf within 2e-2 of its max-abs (mamba2's 3e-2,
    ``tests/test_torch_train_parity.py``'s ``WIDER``: the SSD scan's fp32
    sums over bf16 inputs) or 1.25x the reference's own
    sharded-vs-unsharded spread of that leaf."""
    ref = reference("loss-" + name)
    cfg, tp = _port_params(name)
    tok = torch.from_numpy(_tokens(cfg).astype(np.int64))
    mesh = _mesh()
    loss, grads = loss_and_grads(shard_params(cfg, tp, mesh),
                                 {"tokens": tok, "labels": tok}, cfg,
                                 _dist(mesh))
    rloss = float(ref["loss"])
    got = _grad_table(grads)
    rgrads = {k[len("grad"):]: v for k, v in ref.items()
              if k.startswith("grad[")}
    assert got.keys() == rgrads.keys()
    dist = {k: _rel(got[k], rgrads[k]) for k in rgrads}
    spread = {k: _rel(ref["grad1" + k], rgrads[k]) for k in rgrads}
    record_property("loss", (float(loss), rloss))
    record_property("grad_distance", dist)
    record_property("reference_spread", spread)
    assert abs(float(loss) - rloss) <= TOL * abs(rloss)
    base = WIDER.get(name, (TOL,))[0]
    for k, v in dist.items():
        assert v <= max(base, SPREAD * spread[k]), (k, v, spread[k])


def test_sharded_loss_equals_the_unsharded_port():
    """The same loss and gradients on the mesh against the port's own
    unsharded ``loss_fn``: the loss within 2e-3 relative, each gradient
    leaf within 2e-2 of its max-abs (``tests/test_torch_distribution.py``'s
    rule)."""
    cfg, tp = _port_params(MAMBA2)
    tok = torch.from_numpy(_tokens(cfg).astype(np.int64))
    batch = {"tokens": tok, "labels": tok}
    mesh = _mesh()
    l1, g1 = loss_and_grads(shard_params(cfg, tp, mesh), batch, cfg,
                            _dist(mesh))
    l0, g0 = loss_and_grads(tp, batch, cfg, NO_DIST)
    assert abs(float(l1) - float(l0)) <= 2e-3 * abs(float(l0))
    a, b = _grad_table(g1), _grad_table(g0)
    worst = max((_rel(a[k], b[k]), k) for k in b)
    assert worst[0] <= TOL, worst
