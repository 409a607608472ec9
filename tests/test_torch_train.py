"""The port's training pieces against the reference's, on the CPU at
``.reduced()`` size: ``SyntheticLM`` batches bit for bit, ``cosine_lr``
over steps 0–20,000 within fp32 rounding, one AdamW and one Adafactor
step (then a second, from the reference's first) fed the same gradients —
fp32 moments within 2e-5 relative, bf16 ones (Adafactor's first moment)
and the new bf16 params within one bf16 ulp —
and checkpoints read across both ways, bit for bit. Then the port's own
properties: the reference's checkpoint and pipeline tests mirrored, a
remat step bitwise the plain step, the config fields, the forward-only
kernel ops' refusal under autograd, and the launcher's flags."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro.data.pipeline import BatchSpec as JBatchSpec
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import batch_spec_for as jax_batch_spec_for
from repro.training import checkpoint as JC
from repro.training import optim as JO
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs.base import get_config, list_configs
from repro_torch.data.pipeline import BatchSpec, SyntheticLM, batch_spec_for
from repro_torch.kernels.flash_prefill.ops import flash_prefill_attention
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_decode_attention_layers,
    paged_decode_attention_sharded)
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shardings import gather_tree
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import (init_params, param_count_exact)
from repro_torch.training import (OptState, cosine_lr, latest_checkpoint,
                                  load_checkpoint, make_optimizer,
                                  save_checkpoint)
from repro_torch.training.loop import batch_to
from repro_torch.training.optim import tree_leaves, tree_map

torch.set_num_threads(1)

ARCH = "smollm-360m"
MOMENT_RTOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _leaves(tree, path=""):
    """(path, numpy float32 leaf) pairs of a params / optimizer tree of
    either package, in one order (dict keys sorted, tuples in order)."""
    if isinstance(tree, (OptState, JO.OptState)):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield path, tree.detach().float().numpy()
    else:
        yield path, np.asarray(tree, np.float32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value of ``x`` (8 significand bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["smollm-360m", "internvl2-26b",
                                  "whisper-large-v3"])
def test_synthetic_batches_equal_the_reference(name):
    """Every array of every batch, bit for bit — the patch and audio
    frontends' stub embeddings too."""
    cfg, jcfg = get_config(name).reduced(), jax_config(name).reduced()
    spec, jspec = batch_spec_for(cfg, 3, 40), jax_batch_spec_for(jcfg, 3, 40)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    mine, ref = SyntheticLM(spec, seed=5), JSyntheticLM(jspec, seed=5)
    for step in (0, 1, 17):
        a, b = mine.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(next(iter(mine))["tokens"],
                                  ref.batch(0)["tokens"])


def test_pipeline_deterministic_and_shifted():
    """``tests/test_infra.py``'s pipeline properties in the port: a seed
    fixes the stream, labels are the next tokens, and each row carries
    its injected bigram shift far above the uniform rate."""
    from collections import Counter
    spec = BatchSpec(batch=2, seq=64, vocab=1000)
    a, b = SyntheticLM(spec, seed=3).batch(7), SyntheticLM(spec, seed=3).batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"],
                              SyntheticLM(spec, seed=4).batch(7)["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (2, 64)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    big = SyntheticLM(BatchSpec(batch=8, seq=512, vocab=256), seed=0).batch(0)
    diffs = (big["labels"].astype(int) - big["tokens"].astype(int)) % 256
    for row in diffs:
        assert Counter(row.tolist()).most_common(1)[0][1] > 0.15 * len(row)


# ---------------------------------------------------------------------------
# learning rate and optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base_lr", [3e-4, 1e-3])
def test_cosine_lr_equals_the_reference(base_lr):
    steps = np.arange(0, 20_001, dtype=np.int32)
    ref = np.asarray(JO.cosine_lr(jnp.asarray(steps), base_lr=base_lr))
    mine = cosine_lr(torch.from_numpy(steps), base_lr=base_lr)
    assert mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-6, atol=0)
    assert float(cosine_lr(torch.tensor(0, dtype=torch.int32))) == \
        pytest.approx(3e-6)


def _grads(tree, seed):
    """Seeded bf16 gradients of every leaf's shape: (reference, port)."""
    rng = np.random.default_rng(seed)
    ref = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 1e-2, p.dtype),
        tree)
    return ref, params_from_jax(jax.tree.map(np.asarray, ref), "cpu")


def _port_state(jst) -> OptState:
    """A reference ``OptState`` carried into the port, bit for bit."""
    def leaf(t):
        if isinstance(t, tuple):
            return tuple(tensor_from_numpy(np.asarray(x), "cpu") for x in t)
        return tensor_from_numpy(np.asarray(t), "cpu")

    def tree(t):
        return {k: tree(v) for k, v in t.items()} if isinstance(t, dict) \
            else leaf(t)
    return OptState(step=leaf(jst.step), m=tree(jst.m), v=tree(jst.v))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_equals_the_reference(weights, name):
    """One update of each optimizer from its init state, then a second
    from the reference's first (its params and state carried across bit
    for bit), each fed the same gradients: the moments within 2e-5
    relative (Adafactor's bf16 first moment within one bf16 ulp), the new
    bf16 params within one bf16 ulp, the step counter equal."""
    _, _, jp, tp = weights
    jinit, jupdate = JO.make_optimizer(name)
    init, update = make_optimizer(name)
    jst, st = jinit(jp), init(tp)
    assert [p for p, _ in _leaves(st)] == [p for p, _ in _leaves(jst)]
    for seed in (0, 1):
        if seed:
            tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
            st = _port_state(jst)
        jg, tg = _grads(jp, seed)
        jp, jst = jupdate(jp, jg, jst)
        tp, st = update(tp, tg, st)
        assert st.step.dtype == torch.int32 and int(st.step) == int(jst.step)
        for (path, a), (_, b) in zip(_leaves(tp), _leaves(jp)):
            assert (np.abs(a - b) <= _bf16_ulp(b)).all(), path
        for tree, jtree in ((st.m, jst.m), (st.v, jst.v)):
            for (path, a), (_, b) in zip(_leaves(tree), _leaves(jtree)):
                _close_moment(a, b, bf16=name == "adafactor"
                              and tree is st.m, what=path)


def _close_moment(a, b, *, bf16: bool, what: str) -> None:
    """fp32 moments within 2e-5 relative. Adafactor keeps ``m`` in bf16:
    two fp32 values that close round to the same bf16 value except where
    a rounding boundary falls between them, so there one bf16 ulp; and
    where its update nearly cancels the decayed moment (b1·m ≈ -(1-b1)·u)
    the fp32 difference of the two sides' terms is left, so there 2e-5
    of the leaf's largest magnitude."""
    bound = MOMENT_RTOL * np.abs(b)
    if bf16:
        bound = np.maximum(bound, np.maximum(
            _bf16_ulp(b), MOMENT_RTOL * np.abs(b).max()))
    assert (np.abs(a - b) <= bound).all(), (what, np.abs(a - b).max())


def test_adafactor_factors_every_matrix_leaf(weights):
    _, _, _, tp = weights
    init, _ = make_optimizer("adafactor")
    st = init(tp)
    vr, vc = st.v["embed"]
    assert vr.shape == tp["embed"].shape[:-1]
    assert vc.shape == tp["embed"].shape[1:]
    vr, vc = st.v["attn"]["wq"]
    L, D, F = tp["attn"]["wq"].shape
    assert vr.shape == (L, D) and vc.shape == (L, F)
    assert isinstance(st.v["final_ln"], torch.Tensor)       # 1-D: full v
    assert st.m["embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trained_states(weights, name):
    """(reference params, state), (port params, state) after one update
    of ``name``, so every moment is non-zero."""
    _, _, jp, tp = weights
    jinit, jupdate = JO.make_optimizer(name)
    init, update = make_optimizer(name)
    jg, tg = _grads(jp, 3)
    jp2, jst = jupdate(jp, jg, jinit(jp))
    tp2, st = update(tp, tg, init(tp))
    return (jp2, jst), (tp2, st)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_checkpoints_cross_read_both_ways(weights, tmp_path, name):
    """The port's archive has the reference's names, dtypes and shapes;
    each package restores the other's checkpoint bit for bit."""
    (jp, jst), (tp, st) = _trained_states(weights, name)
    JC.save_checkpoint(str(tmp_path / "ref"), jp, jst, 7)
    save_checkpoint(str(tmp_path / "port"), tp, st, 7)
    with np.load(latest_checkpoint(str(tmp_path / "ref"))) as z, \
            np.load(latest_checkpoint(str(tmp_path / "port"))) as y:
        assert sorted(z.files) == sorted(y.files)
        assert "o.step" in y.files and "p['attn']['wq']" in y.files
        if name == "adafactor":
            assert "o.v['mlp']['w1'][0]" in y.files
        for k in z.files:
            assert z[k].dtype == y[k].dtype and z[k].shape == y[k].shape, k
    # the reference reads the port's checkpoint ...
    zp = jax.tree.map(jnp.zeros_like, jp)
    zo = jax.tree.map(jnp.zeros_like, jst)
    jp2, jst2, step = JC.load_checkpoint(str(tmp_path / "port"), zp, zo)
    assert step == 7
    for (path, a), (_, b) in zip(_leaves((jp2, jst2)), _leaves((tp, st))):
        np.testing.assert_array_equal(a, b, err_msg=path)
    # ... and the port reads the reference's
    zp, zo = tree_map(torch.zeros_like, tp), _zeros_like_state(st)
    tp2, st2, step = load_checkpoint(str(tmp_path / "ref"), zp, zo)
    assert step == 7 and st2.step.dtype == torch.int32
    for (path, a), (_, b) in zip(_leaves((tp2, st2)), _leaves((jp, jst))):
        np.testing.assert_array_equal(a, b, err_msg=path)
    assert tp2["embed"].dtype == torch.bfloat16
    assert os.listdir(tmp_path / "port") == ["ckpt_00000007.npz"]


def _zeros_like_state(st: OptState) -> OptState:
    z = lambda t: tuple(torch.zeros_like(x) for x in t) \
        if isinstance(t, tuple) else torch.zeros_like(t)
    return OptState(step=torch.zeros_like(st.step), m=tree_map(z, st.m),
                    v=tree_map(z, st.v))


def test_checkpoint_round_trip_and_latest(weights, tmp_path):
    """``tests/test_infra.py``'s checkpoint properties in the port: a
    round trip into zeroed trees, the latest of several saves, no
    checkpoint → None."""
    _, _, _, tp = weights
    init, _ = make_optimizer("adamw")
    st = init(tp)
    d = str(tmp_path)
    assert load_checkpoint(d, tp, st) is None
    save_checkpoint(d, tp, st, 10)
    save_checkpoint(d, tp, st, 200)
    assert latest_checkpoint(d).endswith("ckpt_00000200.npz")
    p2, st2, step = load_checkpoint(d, tree_map(torch.zeros_like, tp),
                                    _zeros_like_state(st))
    assert step == 200
    for (path, a), (_, b) in zip(_leaves(p2), _leaves(tp)):
        np.testing.assert_array_equal(a, b, err_msg=path)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["smollm-360m", "jamba-1.5-large-398b"])
def test_remat_step_equals_plain_step_bitwise(name):
    """``remat`` recomputes each layer (a hybrid: each period) in the
    backward pass; on the CPU the step's loss, params and moments are
    bit for bit those of the step that keeps the activations."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = batch_to(SyntheticLM(batch_spec_for(cfg, 2, 48)).batch(0), "cpu")
    init, _ = make_optimizer(cfg.optimizer)
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        outs.append(make_train_step(c)(params, init(params), batch))
    (l0, p0, s0), (l1, p1, s1) = outs
    assert torch.equal(l0, l1)
    for (path, a), (_, b) in zip(_leaves((p0, s0)), _leaves((p1, s1))):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_train_step_returns_fresh_leaves():
    cfg = get_config(ARCH).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = tree_map(torch.clone, params)
    init, _ = make_optimizer(cfg.optimizer)
    batch = batch_to(SyntheticLM(batch_spec_for(cfg, 2, 32)).batch(0), "cpu")
    loss, new, st = make_train_step(cfg)(params, init(params), batch)
    assert loss.grad_fn is None and loss.dtype == torch.float32
    for (path, a), (_, b) in zip(_leaves(params), _leaves(before)):
        np.testing.assert_array_equal(a, b, err_msg=path)   # untouched
    for t in tree_map(lambda x: x, new).values():
        for leaf in (t.values() if isinstance(t, dict) else [t]):
            assert leaf.is_leaf and not leaf.requires_grad
    assert int(st.step) == 1


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list_configs())
def test_training_fields_equal_the_reference(name):
    cfg, ref = get_config(name), jax_config(name)
    assert (cfg.optimizer, cfg.remat) == (ref.optimizer, ref.remat)
    red = cfg.reduced()
    assert (red.optimizer, red.remat) == ("adamw", False)


def test_train_e2e_config_equals_the_reference():
    """``launch/train_e2e.py``'s ~100M config is ``examples/train_e2e.py``'s
    (the cost formula's count: 69.2M with tied embeddings)."""
    from examples.train_e2e import hundred_m_config as ref_config
    from repro_torch.launch.train_e2e import hundred_m_config
    cfg, ref = hundred_m_config(), ref_config()
    assert dataclasses.asdict(cfg) == {
        k: v for k, v in dataclasses.asdict(ref).items()
        if k in dataclasses.asdict(cfg)}
    assert cfg.param_count() == ref.param_count() == 69_206_016


def test_param_count_exact_equals_the_reference(weights):
    _, cfg, jp, tp = weights
    assert param_count_exact(tp) == JT.param_count_exact(jp)


# ---------------------------------------------------------------------------
# the forward-only kernel ops refuse autograd
# ---------------------------------------------------------------------------

def _guard_cases():
    """Each kernel op with small CPU inputs: (name, call(q-like input))."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g).bfloat16()
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    lens = torch.tensor([20], dtype=torch.int32)
    kp, vp = r(3, 16, 2, 32), r(3, 16, 2, 32)
    mesh = Mesh([["cpu"]], ("data", "model"))
    ssd = dict(dt=torch.rand(1, 32, 2), A=-torch.ones(2), B=torch.randn(
        1, 32, 8), C=torch.randn(1, 32, 8))
    k, v = r(1, 16, 2, 32), r(1, 16, 2, 32)
    return [
        ("flash_prefill_attention", lambda q: flash_prefill_attention(
            q, k, v), r(1, 16, 4, 32)),
        ("paged_decode_attention", lambda q: paged_decode_attention(
            q, kp, vp, table, lens), r(1, 4, 32)),
        ("paged_decode_attention_sharded",
         lambda q: paged_decode_attention_sharded(q, kp, vp, table, lens,
                                                  mesh=mesh), r(1, 4, 32)),
        ("paged_decode_attention_layers",
         lambda q: paged_decode_attention_layers(q, kp[None], vp[None],
                                                 table, lens), r(1, 1, 4, 32)),
        ("ssd_scan_op", lambda x: ssd_scan_op(x, chunk=16, **ssd),
         torch.randn(1, 32, 2, 4)),
    ]


@pytest.mark.parametrize("case", range(5))
def test_kernel_ops_refuse_autograd(case):
    """Grad mode on and an input that requires grad: each op raises
    (on every device, before any kernel could launch); under
    ``torch.no_grad()``, or with no input requiring grad, it runs."""
    name, call, x = _guard_cases()[case]
    plain = call(x)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{name} is forward-only"):
        call(x)
    with torch.no_grad():
        out = call(x)
    for a, b in zip(plain if isinstance(plain, tuple) else (plain,),
                    out if isinstance(out, tuple) else (out,)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path)
    args = ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--ckpt", d,
            "--ckpt-every", "3"]
    assert train_launcher.main(args) == 0
    assert "done: 3 steps" in capsys.readouterr().out
    assert latest_checkpoint(d).endswith("ckpt_00000003.npz")
    assert train_launcher.main(args[:-2] + ["--resume"]) == 0
    assert latest_checkpoint(d).endswith("ckpt_00000003.npz")


@pytest.mark.parametrize("mesh", ["prod", "prod-multipod"])
def test_launcher_refuses_a_mesh(mesh):
    """The reference's TPU pod meshes have no GPU counterpart."""
    with pytest.raises(ValueError, match="TPU pod mesh"):
        train_launcher.main(["--arch", ARCH, "--reduced", "--mesh", mesh,
                             "--device", "cpu"])


def test_launcher_trains_on_a_mesh(tmp_path):
    """``--mesh 2x2 --device cpu``: 3 sharded steps; the checkpoint holds
    whole leaves, loads unsharded into the port bit for bit against the
    run's gathered params, and the reference's ``load_checkpoint`` reads
    it."""
    d = str(tmp_path)
    res = train_launcher.run(["--arch", ARCH, "--reduced", "--mesh", "2x2",
                              "--steps", "3", "--batch", "4", "--seq", "64",
                              "--device", "cpu", "--ckpt", d,
                              "--ckpt-every", "3"])
    assert res.steps == 3 and all(np.isfinite(res.losses))
    assert latest_checkpoint(d).endswith("ckpt_00000003.npz")
    cfg = get_config(ARCH).reduced()
    tp = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    opt_init, _ = make_optimizer(cfg.optimizer)
    p2, st2, step = load_checkpoint(d, tp, opt_init(tp))
    assert step == 3 and int(st2.step) == 3
    run_params = gather_tree(res.params, "cpu")
    for a, b in zip(tree_leaves(p2), tree_leaves(run_params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jcfg = jax_config(ARCH).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jp2, _, jstep = JC.load_checkpoint(d, jp, JO.adamw_init(jp))
    assert jstep == 3
    tree_map(lambda b, a: np.testing.assert_array_equal(
        np.asarray(a, np.float32), b.float().numpy()), run_params, jp2)
