"""The package surface of the port against the reference's: every name
that ``repro.kernels``, its three kernel subpackages and ``repro.data``
export imports from the port's counterpart, and gives the reference's
export's result on the same inputs; the two oracles the port
added, ``ssd_scan_ref`` and ``paged_attention_split_ref``, against the
reference's on the same numpy inputs (2e-5 with fp32 inputs, 2e-2 with
bf16, ``tests/test_kernels.py:44``'s tolerances); the split oracle's
bitwise property (``tests/test_sharded_paged.py:149-168``) inside the
port; ``ModelConfig.kv_shardable``, ``SSMConfig.n_groups`` and
``BackpressureSignal.slot_frac`` equal to the reference's; and
``StateCheckpointWorker(chunk=)`` against the reference's worker at a
stride of 256 and unchanged at its default."""
import dataclasses
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.base import SSMConfig as JSSMConfig
from repro.configs.base import get_config as jax_config
from repro.configs.base import list_configs as jax_list_configs
from repro.core.policies.admission import \
    BackpressureSignal as JBackpressureSignal
from repro.kernels.paged_attention.ref import \
    paged_attention_split_ref as jax_split_ref
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.serving.engine import StateCheckpointWorker as JWorker
from repro_torch.bridge import params_from_jax, tensor_from_numpy, \
    tensor_to_numpy
from repro_torch.configs.base import SSMConfig, get_config
from repro_torch.core.policies import BackpressureSignal
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_attention_split_ref)
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_ref
from repro_torch.serving.engine import BLOCK_TOKENS, StateCheckpointWorker

torch.set_num_threads(1)

TOL = {"f32": 2e-5, "bf16": 2e-2}
PACKAGES = ["kernels", "kernels.flash_prefill", "kernels.paged_attention",
            "kernels.ssd_scan", "data"]


def _exports(mod) -> list:
    """The public functions and classes a package binds (its submodules
    left out)."""
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not inspect.ismodule(v)
                  and n != "annotations")


@pytest.mark.parametrize("package", PACKAGES)
def test_every_reference_export_imports_from_the_port(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    names = _exports(ref)
    assert names
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    for n in names:
        assert callable(getattr(port, n)), n


def _call_both(name, package, args, kw=None):
    """``package``'s export ``name`` of both packages on the same numpy
    inputs (jnp arrays for the reference, CPU tensors for the port)."""
    ref = getattr(importlib.import_module(f"repro.{package}"), name)
    port = getattr(importlib.import_module(f"repro_torch.{package}"), name)
    return (port(*(tensor_from_numpy(np.asarray(a), "cpu") for a in args),
                 **(kw or {})),
            ref(*(jnp.asarray(a) for a in args), **(kw or {})))


@pytest.mark.parametrize("name", [
    "flash_prefill_attention", "flash_prefill_ref", "paged_decode_attention",
    "paged_attention_ref", "paged_decode_attention_layers",
    "paged_attention_layers_ref", "ssd_scan_op", "ssd_naive_ref"])
def test_exported_ops_match_the_reference_exports(name):
    """Each exported op and oracle, imported from the package as a user
    imports it, against the reference's export of that name on the same
    bf16 inputs (2e-2; the SSD scan's fp32 outputs alike)."""
    rng = np.random.default_rng(11)
    if name.startswith("flash"):
        args = [_arr(rng, (1, 64, 4, 32), "bf16"),
                _arr(rng, (1, 128, 2, 32), "bf16"),
                _arr(rng, (1, 128, 2, 32), "bf16")]
        outs = _call_both(name, "kernels.flash_prefill", args,
                          {"q_offset": 64})
    elif name.startswith("paged"):
        args = list(_paged("bf16"))
        if "layers" in name:
            args[:3] = [np.stack([a, _arr(rng, a.shape, "bf16")])
                        for a in args[:3]]
        outs = _call_both(name, "kernels.paged_attention", args)
    else:
        b, s, h, p, n = 1, 64, 2, 16, 16
        args = [_arr(rng, (b, s, h, p), "bf16"),
                np.log1p(np.exp(rng.standard_normal((b, s, h)))
                         ).astype(np.float32),
                -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32),
                _arr(rng, (b, s, n), "bf16"), _arr(rng, (b, s, n), "bf16")]
        outs = _call_both(name, "kernels.ssd_scan", args,
                          {"chunk": 32} if name == "ssd_scan_op" else None)
    got, want = outs
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, TOL["bf16"])
    else:
        _close(got, want, TOL["bf16"])


def test_data_exports_match_the_reference_exports():
    """``repro_torch.data``'s exports give the reference's batch spec,
    synthetic batches and request tokens, bit for bit."""
    import repro.data as JD
    import repro_torch.data as TD
    from repro.core.trace import Request as JRequest
    from repro_torch.core.trace import Request
    cfg, jcfg = get_config("internvl2-26b").reduced(), \
        jax_config("internvl2-26b").reduced()
    spec, jspec = TD.batch_spec_for(cfg, 2, 32), JD.batch_spec_for(jcfg, 2, 32)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert isinstance(spec, TD.BatchSpec)
    got, want = TD.SyntheticLM(spec, seed=3).batch(1), \
        JD.SyntheticLM(jspec, seed=3).batch(1)
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    kw = dict(req_id=7, timestamp=0, input_length=700, output_length=5,
              hash_ids=[11, 12])
    assert np.array_equal(TD.realize_request_tokens(Request(**kw), 512),
                          JD.realize_request_tokens(JRequest(**kw), 512))


def test_importing_the_kernels_builds_nothing():
    """The exports load the ops and oracles; no kernel is built by an
    import (a CPU run has no compiler)."""
    from repro_torch.kernels import _build
    import repro_torch.kernels  # noqa: F401
    assert not _build._libs


def _arr(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(jnp.bfloat16) if dtype == "bf16" else a


def _close(port, ref, tol):
    np.testing.assert_allclose(tensor_to_numpy(port),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------ ssd_scan_ref --

SSD_CASES = [(2, 128, 4, 32, 16, 32, False), (1, 64, 2, 16, 32, 16, True)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_ref_matches_the_reference(case, dtype):
    """y (fp32) and the final state of the port's ``ssd_scan_ref`` against
    the reference's on the same inputs; the port's is ``ssd_chunked``'s
    result, y cast to fp32."""
    b, s, h, p, n, chunk, with_h0 = case
    rng = np.random.default_rng(5)
    x, B, C = (_arr(rng, shp, dtype) for shp in
               ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_h0 else None
    args = (x, dt, A, B, C)
    jy, js = jax_ssd_scan_ref(*(jnp.asarray(a) for a in args), chunk=chunk,
                              h0=None if h0 is None else jnp.asarray(h0))
    ta = [tensor_from_numpy(np.asarray(a), "cpu") for a in args]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, st = ssd_scan_ref(*ta, chunk=chunk, h0=th0)
    assert y.dtype == st.dtype == torch.float32
    _close(y, jy, TOL[dtype])
    _close(st, js, TOL[dtype])
    y2, st2 = ssd_chunked(*ta, chunk, h0=th0)
    assert torch.equal(y, y2.float()) and torch.equal(st, st2)


# ----------------------------------------------- paged_attention_split_ref --

def _paged(dtype, B=4, H=8, KV=4, D=16, P=9, page=8, seed=3):
    rng = np.random.default_rng(seed)
    q = _arr(rng, (B, H, D), dtype)
    kp = _arr(rng, (P, page, KV, D), dtype)
    vp = _arr(rng, (P, page, KV, D), dtype)
    tbl = rng.integers(1, P, (B, 4)).astype(np.int32)
    lens = np.asarray([30, 17, 8, 25][:B], np.int32)
    return q, kp, vp, tbl, lens


SPLITS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 4), (2, 4)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 12])
def test_split_ref_matches_the_reference(dtype, window):
    """Every (n_data, n_model) split of the port's oracle against the
    reference's on the same inputs."""
    arrays = _paged(dtype)
    ta = [tensor_from_numpy(np.asarray(a), "cpu") for a in arrays]
    for nd, nm in SPLITS:
        ref = jax_split_ref(*(jnp.asarray(a) for a in arrays), n_model=nm,
                            n_data=nd, window=window)
        got = paged_attention_split_ref(*ta, n_model=nm, n_data=nd,
                                        window=window)
        _close(got, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_ref_matches_ref_bitwise(dtype):
    """The reference's property inside the port: the split-and-concat
    decomposition is bitwise the unsplit one (head-local, row-local
    attention), which is the plain oracle ``paged_attention_ref`` up to
    the order of its sums (within the file's tolerance)."""
    ta = [tensor_from_numpy(np.asarray(a), "cpu") for a in _paged(dtype)]
    whole = paged_attention_split_ref(*ta)
    _close(whole, tensor_to_numpy(paged_attention_ref(*ta)), TOL[dtype])
    for nd, nm in SPLITS:
        got = paged_attention_split_ref(*ta, n_model=nm, n_data=nd)
        assert torch.equal(got, whole), (nd, nm)


def test_split_ref_refuses_a_split_that_does_not_divide():
    ta = [tensor_from_numpy(np.asarray(a), "cpu") for a in _paged("f32")]
    with pytest.raises(ValueError, match="do not split"):
        paged_attention_split_ref(*ta, n_model=3)


# ------------------------------------------------------------ the members --

@pytest.mark.parametrize("name", jax_list_configs())
def test_kv_shardable_equals_the_reference(name):
    for reduced in (False, True):
        ref, port = jax_config(name), get_config(name)
        if reduced:
            ref, port = ref.reduced(), port.reduced()
        assert port.kv_shardable == ref.kv_shardable, (name, reduced)
        if ref.ssm is not None:
            assert port.ssm.n_groups == ref.ssm.n_groups == 1


def test_ssm_config_refuses_other_group_counts():
    assert SSMConfig().n_groups == JSSMConfig().n_groups == 1
    assert [f.name for f in dataclasses.fields(SSMConfig)] == \
        [f.name for f in dataclasses.fields(JSSMConfig)]
    with pytest.raises(ValueError, match="one B/C group"):
        SSMConfig(n_groups=2)


@pytest.mark.parametrize("counts", [(0, 8, 0, 4), (3, 8, 2, 4),
                                    (8, 8, 4, 4), (1, 0, 3, 0)])
def test_slot_frac_equals_the_reference(counts):
    q, qc, used, total = counts
    kw = dict(queue_depth=q, queue_capacity=qc, slots_used=used,
              slots_total=total, prefills_active=1, pages_pinned=5,
              pages_total=10, spilled=1)
    port, ref = BackpressureSignal(**kw), JBackpressureSignal(**kw)
    assert port.slot_frac == ref.slot_frac
    assert port.queue_frac == ref.queue_frac
    assert port.page_frac == ref.page_frac


# ------------------------------------------------- the checkpoint stride --

@pytest.fixture(scope="module")
def mamba():
    jcfg = jax_config("mamba2-2.7b").reduced()
    cfg = get_config("mamba2-2.7b").reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(9)
    shared = rng.integers(0, cfg.vocab_size, 512)
    toks = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
            for n in (96, 40)]
    return jcfg, cfg, jp, tp, toks


def test_checkpoint_stride_matches_the_reference(mamba):
    """At ``chunk=256`` the port's worker snapshots at every 256-token
    boundary as the reference's does: the same checkpoints, counters and
    first tokens; the second request restores 512 tokens."""
    jcfg, cfg, jp, tp, toks = mamba
    jw = JWorker(jp, jcfg, chunk=256)
    tw = StateCheckpointWorker(tp, cfg, chunk=256)
    for t in toks:
        assert tw(t)[0] == jw(t)[0]
    assert tw.chunk == jw.chunk == 256
    assert set(tw.data) == set(jw.data) and len(tw.data) == 2
    assert tw.stats() == jw.stats()
    assert tw.stats()["restored_tokens"] == 512


def test_checkpoint_stride_defaults_to_a_block(mamba):
    """The default stride is ``BLOCK_TOKENS``: the same results, bit for
    bit, as a worker given it."""
    _, cfg, _, tp, toks = mamba
    a = StateCheckpointWorker(tp, cfg)
    b = StateCheckpointWorker(tp, cfg, chunk=BLOCK_TOKENS)
    assert a.chunk == BLOCK_TOKENS
    for t in toks:
        (fa, ca), (fb, cb) = a(t), b(t)
        assert fa == fb and ca.length == cb.length
        assert torch.equal(ca.ssm.ssm, cb.ssm.ssm)
        assert torch.equal(ca.ssm.conv, cb.ssm.conv)
    assert a.stats() == b.stats() and set(a.data) == set(b.data)
