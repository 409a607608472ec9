"""The port's quickstart and overload-replay entry points against the
reference's ``examples/quickstart.py`` and ``examples/overload_replay.py``
(loaded by path), stdout line for line under the reference's ``V5E``
hardware values; section 4's prefix reuse with the reference's
``smollm-360m.reduced()`` weights carried across through ``bridge.py``;
and the entry points' own behaviour under the port's H100 default."""
import contextlib
import dataclasses
import io
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro.core.costmodel import V5E
from repro.serving.engine import HostKVPool as JHostKVPool
from repro.serving.engine import PrefillWorker as JPrefillWorker
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.core.costmodel import Hardware, InstanceSpec
from repro_torch.core.trace import TraceSpec, generate_trace
from repro_torch.launch import overload_replay, quickstart

torch.set_num_threads(1)

V5E_INST = InstanceSpec(n_chips=16, hw=Hardware(**dataclasses.asdict(V5E)))
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _stdout(fn, *args, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


def _example(name: str) -> dict:
    return runpy.run_path(os.path.join(EXAMPLES, name))


def test_quickstart_prints_the_reference_lines():
    """Sections 1–3 priced on V5E values, and section 4's header and
    reuse counts (reduced smollm on the CPU), line for line."""
    out = _stdout(quickstart.main, ["--requests", "300", "--device", "cpu"],
                  inst_spec=V5E_INST)
    ref = _stdout(_example("quickstart.py")["main"], ["--requests", "300"])
    assert out.splitlines() == ref.splitlines()
    assert "3. Conductor scheduling strategies" in out
    assert "computed only 64 tokens" in out


def test_quickstart_engine_section_with_reference_weights():
    """Section 4 on the reference's weights: the same prompt lengths,
    reused and new blocks as the reference's ``PrefillWorker``."""
    jcfg = jax_config("smollm-360m").reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    cfg = get_config("smollm-360m").reduced()
    lines = []
    r1, r2 = quickstart.engine_section(params, cfg, "cpu", log=lines.append)
    pw = JPrefillWorker(jp, jcfg, JHostKVPool(), prefill_chunk=128)
    rng = np.random.default_rng(0)
    doc = rng.integers(0, jcfg.vocab_size, 1024)
    j1 = pw(np.concatenate([doc, rng.integers(0, jcfg.vocab_size, 64)]))
    j2 = pw(np.concatenate([doc, rng.integers(0, jcfg.vocab_size, 64)]))
    for r, j in ((r1, j1), (r2, j2)):
        assert (r.prompt_len, r.reused_blocks, r.new_blocks) == \
            (j.prompt_len, j.reused_blocks, j.new_blocks)
    assert (r1.reused_blocks, r2.reused_blocks) == (0, 2)
    assert r2.prompt_len - 512 * r2.reused_blocks == 64
    assert lines[-1].endswith("computed only 64 tokens")


def test_quickstart_without_a_gpu_raises(monkeypatch):
    """No ``--device cpu`` and no GPU: the entry point raises before any
    section runs, nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(RuntimeError, match="no GPU"):
        quickstart.main(["--requests", "50"])
    assert buf.getvalue() == ""


def test_quickstart_on_the_h100_default():
    lines = []
    trace = quickstart.simulator_sections(200, log=lines.append)
    assert lines[2].startswith(f"   {len(trace)} requests")
    fig8 = [ln for ln in lines if "avg TTFT" in ln]
    assert len(fig8) == len(quickstart.list_policies("prefill"))
    for ln in fig8:
        ttft = float(ln.split("avg TTFT")[1].split("s")[0])
        assert np.isfinite(ttft) and ttft > 0


def test_overload_replay_prints_the_reference_lines(monkeypatch):
    out = _stdout(overload_replay.main, ["--requests", "300"],
                  inst_spec=V5E_INST)
    monkeypatch.setattr(sys, "argv", ["overload_replay.py", "--requests",
                                      "300"])
    ref = _stdout(_example("overload_replay.py")["main"])
    assert out.splitlines() == ref.splitlines()
    for adm in ("baseline", "early", "predictive"):
        assert f"--- {adm} ---" in out


def test_overload_replay_h100_invariants():
    """The replay body under the port's default, on a trace dense
    enough (800 requests in two minutes) that 32x overloads the H100
    cluster: every request completes or is rejected, every accepted one
    completes, and only ``baseline`` rejects after prefill."""
    reqs = generate_trace(TraceSpec(n_requests=800, duration_ms=120_000,
                                    seed=2, out_mu=5.9))
    lines = []
    results = overload_replay.replay(reqs, 32.0, log=lines.append)
    assert sorted(results) == ["baseline", "early", "predictive"]
    rejected = 0
    for adm, res in results.items():
        assert len(res.completed()) + len(res.rejected()) == len(reqs)
        assert all(r.completed for r in res.records if r.accepted)
        waste = sum(1 for r in res.records
                    if r.reject_stage == "decode_doublecheck")
        if adm != "baseline":
            assert waste == 0
        rejected += len(res.rejected())
    assert rejected, "32x must overload the 8P+8D H100 cluster"
    assert sum(ln.startswith("rejected ") for ln in lines) == 3
