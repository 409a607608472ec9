"""Public op: chunked-prefill flash attention. A CPU tensor takes the
plain PyTorch version; a CUDA tensor launches the hand-written kernel
(or the wrapper raises) — there is no fallback between the two."""
from __future__ import annotations

from repro_torch.kernels.flash_prefill.kernel import flash_prefill
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.kernels.paged_attention.ops import grouped_map


def flash_prefill_attention(q, k, v, *, q_offset: int = 0, window: int = 0,
                            qh2kv=None):
    """q (B, Sq, H, D); k, v (B, Sk, KV, D) → (B, Sq, H, D)."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, q_offset=q_offset, window=window,
                                 qh2kv=qh2kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash prefill runs on cpu or cuda, not {q.device}")
    if qh2kv is None:
        qh2kv = grouped_map(q.shape[2], k.shape[2], q.device)
    return flash_prefill(q, k, v, qh2kv, q_offset=q_offset, window=window)
