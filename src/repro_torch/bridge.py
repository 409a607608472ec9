"""Weight and state bridge: the reference's ``init_params`` pytree, with
its leaves turned into numpy arrays, to the port's parameter dict (same
keys, shapes and dtypes, the fp32 SSM leaves included), and Mamba2 state
checkpoints both ways (``StateCheckpointWorker.data`` holds them as
numpy pairs in the reference). numpy is the only currency between the
two packages — this module imports neither jax nor the reference.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects; they cross as their 16-bit patterns
(``.view(np.int16)``) and are reinterpreted as ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.mamba import MambaState


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array → tensor on ``device``, bit-for-bit (bf16 included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(resolve_device(device))


def params_from_jax(params_np: dict, device="cuda") -> dict:
    """Nested dict of numpy leaves → nested dict of tensors on ``device``."""
    return {k: params_from_jax(v, device) if isinstance(v, dict)
            else tensor_from_numpy(v, device)
            for k, v in params_np.items()}


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor → float32 numpy (bf16 widened exactly), for comparisons."""
    return t.detach().float().cpu().numpy()


def state_from_numpy(ssm, conv, device="cuda") -> MambaState:
    """A reference checkpoint ``(ssm np fp32, conv np bf16)`` → a
    ``MambaState`` on ``device`` (bit-for-bit; a conv given widened to
    fp32 is narrowed back to bf16 exactly)."""
    return MambaState(ssm=tensor_from_numpy(ssm, device).float(),
                      conv=tensor_from_numpy(conv, device).to(torch.bfloat16))


def state_to_numpy(state: MambaState) -> tuple:
    """A ``MambaState`` → ``(ssm np fp32, conv np fp32)``: the conv tail
    is bf16, widened exactly (numpy has no bf16); ``jnp.asarray(conv,
    jnp.bfloat16)`` restores the reference's checkpoint bit for bit."""
    return tensor_to_numpy(state.ssm), tensor_to_numpy(state.conv)
