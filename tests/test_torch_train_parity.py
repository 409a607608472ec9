"""The port's training loss and its gradients against the reference's
``jax.value_and_grad(loss_fn)``, on the reference's ``init_params``
weights carried across by the bridge and the same ``SyntheticLM`` batch,
at ``.reduced()`` size (batch 2 × 64 tokens): the loss within 2e-3
relative, each gradient leaf within ``GRAD_TOL`` of that leaf's largest
magnitude. This file holds the dense, SSM, encoder-decoder and patch
families against the reference's compiled run;
``test_torch_train_moe.py`` holds the MoE and hybrid families.

2e-2 of the max-abs sits at the floor of bf16 rounding noise: the
reference's own compiled and op-by-op gradients differ by 1.4–2.1e-2
here, and both packages' bf16 gradients lie 0.9–2.8e-2 from the fp32
gradient of the same math. Families whose port-vs-reference distance
measured above 2e-2 get a wider bound in ``WIDER``, each with its
measured distance and reason (ROADMAP §3 records them). For every
family the test also checks that the port's bf16 gradient is no
further from the fp32 gradient (the port's forward on fp32 copies of the
same weights, under the same routing) than 1.25× the reference's is:
the port loses no accuracy the reference keeps."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import batch_spec_for as jax_batch_spec_for
import repro_torch.models.layers as TL
from repro_torch.bridge import params_from_jax, tensor_to_numpy
from repro_torch.configs.base import get_config
from repro_torch.launch.steps import loss_and_grads
from repro_torch.training.optim import tree_map

torch.set_num_threads(1)

LOSS_RTOL = 2e-3
GRAD_TOL = 2e-2
FP32_RATIO = 1.25
B, S = 2, 64
#: family → (bound, why). Distances are the largest over leaves of
#: max|port − ref| / max|ref|, measured on this file's inputs.
WIDER = {
    # 2.67e-2 (mamba/norm) against the compiled reference, 2.27e-2
    # against its op-by-op run, which differs from the compiled one by
    # 1.88e-2; to the fp32 gradient: port 2.00e-2, reference 1.90e-2
    "mamba2-2.7b": (3e-2, "the SSD scan's fp32 sums over bf16 inputs"),
    # 2.08e-2 (enc_attn/ln); the reference's compiled and op-by-op runs
    # differ by 2.04e-2; to the fp32 gradient: port 1.32e-2, reference
    # 1.83e-2
    "whisper-large-v3": (3e-2, "a norm weight's sum over every frame"),
    # 2.15e-2 (attn/ln) against the op-by-op reference whose routing it
    # replays; the reference's own two runs differ by 2.15e-2; to the
    # fp32 gradient: port 1.46e-2, reference 1.65e-2
    "mixtral-8x7b": (3e-2, "a norm weight's sum over every token"),
    # 1.01e-1 (mamba/dt_bias) under the op-by-op reference's routing;
    # eight layers carry bf16 rounding further (the hybrid's logits are
    # held at 4e-2 for the same reason, tests/test_torch_hybrid.py); to
    # the fp32 gradient: port 6.76e-2, reference 9.29e-2; the
    # reference's compiled run routes differently and sits 3.21e-1 from
    # its own op-by-op gradient
    "jamba-1.5-large-398b": (0.15, "eight layers of bf16 rounding"),
}


def _tree_np(tree, path=""):
    """(path, float32 numpy) leaves of a params-like tree, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_np(tree[k], f"{path}/{k}")
    elif isinstance(tree, torch.Tensor):
        yield path, tensor_to_numpy(tree)
    else:
        yield path, np.asarray(tree, np.float32)


def _distance(port, ref):
    """Largest over leaves of max|port − ref| / max|ref| → (d, path)."""
    worst = (0.0, None)
    for (path, a), (p2, b) in zip(_tree_np(port), _tree_np(ref)):
        assert path == p2 and a.shape == b.shape, (path, p2)
        d = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        worst = max(worst, (d, path), key=lambda t: t[0])
    return worst


def _port_grads(params, batch, cfg, routes, dtype=None):
    """(loss, grads) of the port's train step (``loss_and_grads``), under
    ``routes`` (the reference's MoE routing, replayed) when given."""
    if dtype is not None:
        params = tree_map(lambda p: p.to(dtype), params)
    with TL.replay_routing(routes) if routes else contextlib.nullcontext():
        loss, grads = loss_and_grads(params, batch, cfg)
    return float(loss), grads


def _reference(jp, jb, jcfg, op_by_op: bool, monkeypatch):
    """The reference's (loss, grads): compiled, or op by op with every
    MoE call's (T, k) expert ids recorded in call order (its routing,
    which the port then replays)."""
    f = jax.value_and_grad(lambda p: JT.loss_fn(p, jb, jcfg))
    if not op_by_op:
        loss, grads = jax.jit(f)(jp)
        return float(loss), grads, []
    routes, route = [], JL._route

    def recording(xf, w, k):
        g, idx, aux = route(xf, w, k)
        routes.append(torch.from_numpy(np.asarray(idx).astype(np.int64)))
        return g, idx, aux

    monkeypatch.setattr(JL, "_route", recording)
    with jax.disable_jit():
        loss, grads = f(jp)
    monkeypatch.setattr(JL, "_route", route)
    return float(loss), grads, routes


def hold_loss_and_grads(name, monkeypatch, record_property,
                        op_by_op: bool = False):
    jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    nb = JSyntheticLM(jax_batch_spec_for(jcfg, B, S), seed=0).batch(0)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jloss, jgrads, routes = _reference(jp, jb, jcfg, op_by_op, monkeypatch)
    if cfg.moe is not None:
        assert routes, f"{name}: the MoE routing must be replayed"
    loss, grads = _port_grads(tp, tb, cfg, list(routes))
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    d, where = _distance(grads, jgrads)
    bound = WIDER.get(name, (GRAD_TOL, ""))[0]
    record_property("grad_distance", d)
    assert d <= bound, (name, where, d, bound)
    # accuracy against the fp32 gradient of the same math and routing
    _, g32 = _port_grads(tp, tb, cfg, list(routes), dtype=torch.float32)
    port32, _ = _distance(grads, g32)
    ref32, _ = _distance(jgrads, g32)
    record_property("port_to_fp32", port32)
    record_property("reference_to_fp32", ref32)
    assert port32 <= FP32_RATIO * ref32, (name, port32, ref32)


@pytest.mark.parametrize("name", ["smollm-360m", "qwen3-14b", "mamba2-2.7b",
                                  "whisper-large-v3", "internvl2-26b"])
def test_loss_and_grads_match_the_reference(name, monkeypatch,
                                            record_property):
    """smollm (padded heads over 2 KV heads, tied embeddings), qwen3-14b
    (qk_norm, padded heads), mamba2 (the SSD scan), whisper (encoder,
    cross-attention, frames) and internvl2 (patches prepended, their
    labels masked)."""
    hold_loss_and_grads(name, monkeypatch, record_property)
