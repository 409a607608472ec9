"""The port's cluster launcher against the reference's
``examples/serve_cluster.py`` (``smollm-360m.reduced()``, weights carried
by ``bridge.params_from_jax``; the wire, chaos and process cases are in
``tests/test_torch_cluster.py``):

* the Conductor lane under the reference's ``V5E`` hardware values and a
  fake clock, against the reference's example run with its module
  ``time`` patched to the same clock: every request's prefill and decode
  instance, prompt length, reused blocks and migration flag, and the
  summary counters, line for line; tokens equal wherever the reference's
  top-2 logit gap exceeds 4e-2;
* inside the port: paged and dense decode bit-equal, a hot-spot
  migration that copies real blocks, the global-pool lane fetching peer
  blocks and feeding the store's read time to the cost model, and the
  serving-loop lane.

Every run closes its pools, so the conftest thread and fd checks pass."""
import dataclasses
import importlib.util
import itertools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro.core.costmodel import V5E
from repro.serving.engine import DecodeWorker as JDecodeWorker
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.core.costmodel import Hardware
from repro_torch.data.pipeline import realize_request_tokens
from repro_torch.launch.serve_cluster import make_trace, serve_cluster

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAP = 4e-2
ARCH = "smollm-360m"
N_REQ = 12                 # trace requests of the launcher lanes
V5E_HW = Hardware(**dataclasses.asdict(V5E))


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


# ---------------------------------------------------------------------------
# the launcher's Conductor lane against examples/serve_cluster.py
# ---------------------------------------------------------------------------

def _fake_clock():
    """A deterministic wall clock: every read advances it 0.25 s."""
    c = itertools.count()
    return lambda: 1000.0 + 0.25 * next(c)


def _reference_cluster(argv, capsys):
    """Run the reference example's main with its module ``time`` on the
    fake clock; returns (printed lines, {req_id: tokens})."""
    spec = importlib.util.spec_from_file_location(
        "ref_serve_cluster", os.path.join(REPO, "examples",
                                          "serve_cluster.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.time = types.SimpleNamespace(time=_fake_clock())
    streams: dict = {}

    class Recording(JDecodeWorker):
        def join(self, request, pres, **kw):
            streams[request.req_id] = [int(pres.first_token)]
            return super().join(request, pres, **kw)

        def step(self):
            out = super().step()
            for rid, tok, _fin in out:
                streams[rid].append(int(tok))
            return out

    mod.DecodeWorker = Recording
    old = sys.argv
    sys.argv = ["serve_cluster.py", *argv]
    try:
        capsys.readouterr()
        mod.main()
        printed = capsys.readouterr().out
    finally:
        sys.argv = old
    return [l for l in printed.splitlines() if l.strip()], streams


def _assert_parity(jp, jcfg, prompt, ref, port):
    """The streams agree up to their first divergence, which must sit on
    a near-tie of the reference's logits."""
    assert len(ref) == len(port)
    i = next((i for i in range(len(ref)) if ref[i] != port[i]), None)
    if i is None:
        return 0
    ctx = np.concatenate([prompt, np.asarray(ref[:i], prompt.dtype)])
    logits, _ = JT.prefill(jp, jnp.asarray(ctx[None]), jcfg)
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    assert top2[1] - top2[0] <= GAP, (i, top2)
    return 1


def _v5e_lane(cfg, tp, **kw):
    lines: list = []
    s = serve_cluster(cfg, "cpu", params=tp, hardware=V5E_HW, n_chips=16,
                      clock=_fake_clock(), requests=N_REQ,
                      log=lambda m: lines.extend(
                          l for l in m.splitlines() if l.strip()), **kw)
    return s, lines


@pytest.fixture(scope="module")
def conductor_lane(weights):
    """The port's Conductor lane under V5E and the fake clock (paged)."""
    _, cfg, _, tp = weights
    return _v5e_lane(cfg, tp)


def test_conductor_lane_matches_reference(weights, conductor_lane, capsys):
    jcfg, cfg, jp, tp = weights
    ref_lines, ref_streams = _reference_cluster(
        ["--requests", str(N_REQ)], capsys)
    s, lines = conductor_lane
    # per-request routing (prefill and decode instance, prompt length,
    # reused blocks, migration) and every summary counter, line for line
    assert lines == ref_lines
    assert s["served"] == len(ref_streams) > 0 and s["pages_leak_free"]
    prompts = {r.req_id: realize_request_tokens(r, cfg.vocab_size)
               for r in make_trace(N_REQ)}
    ties = sum(_assert_parity(jp, jcfg, prompts[rid], ref_streams[rid],
                              s["outputs"][rid]) for rid in ref_streams)
    print(f"conductor lane: {ties} of {len(ref_streams)} streams diverged "
          f"at a near-tie")


# ---------------------------------------------------------------------------
# the other lanes, inside the port
# ---------------------------------------------------------------------------

def test_paged_and_dense_lanes_bit_equal(weights, conductor_lane):
    _, cfg, _, tp = weights
    paged, paged_lines = conductor_lane
    dense, dense_lines = _v5e_lane(cfg, tp, decode_substrate="dense")
    assert paged["zero_copy_joins"] == paged["served"] > 0
    assert dense["records"] == paged["records"]
    assert dense["outputs"] == paged["outputs"]


def test_hot_spot_migration_copies_real_blocks(weights, conductor_lane):
    """A clock that stands still lets the cache holder's modelled queue
    grow, so Algorithm 1 migrates a hot prefix to the other instance; the
    launcher copies the prefix's blocks between the real pools under the
    engine's keys, the migrated request reuses them, and every token
    equals the lane whose clock runs."""
    _, cfg, _, tp = weights
    s = serve_cluster(cfg, "cpu", params=tp, requests=N_REQ,
                      clock=lambda: 0.0, log=lambda m: None)
    moved = [r for r in s["records"] if r.get("migrated")]
    assert moved and s["migrations"] == s["conductor_migrations"] \
        == len(moved)
    assert all(r["reused"] > 0 for r in moved)
    assert s["outputs"] == conductor_lane[0]["outputs"]
    assert s["pages_leak_free"]


def test_global_pool_lane(weights, conductor_lane, tmp_path):
    """Random routing spreads one session's turns over both instances, so
    blocks one instance holds are fetched by the other through the shared
    directory; blocking loads feed the store's read EMA back into the
    cost model; the tokens equal the flat-pool lane's bit for bit."""
    _, cfg, _, tp = weights
    g = serve_cluster(cfg, "cpu", params=tp, requests=N_REQ,
                      global_pool=True, ssd_blocks=64, dram_blocks=2,
                      ssd_dir=str(tmp_path), strategy="random",
                      ssd_mode="blocking", log=lambda m: None)
    assert g["peer_blocks_fetched"] > 0 and g["peer_fetch_failures"] == 0
    assert not g["fallback_reasons"]
    assert g["ssd_read_ema"] is not None and g["pages_leak_free"]
    assert g["outputs"] == conductor_lane[0]["outputs"]


def test_loop_lane(weights, conductor_lane):
    _, cfg, _, tp = weights
    s = serve_cluster(cfg, "cpu", params=tp, requests=N_REQ, loop=True,
                      log=lambda m: None)
    assert s["lane"] == "loop" and s["rejected"] == 0
    assert s["served"] == len(s["payloads"]) == conductor_lane[0]["served"]
    for rid, _toks, mn, _sess in s["payloads"]:
        assert len(s["outputs"][rid]) == mn
    assert s["pages_leak_free"]
