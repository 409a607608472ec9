"""Operations and bytes at the published sizes, and the card's peaks.

Every count is of the published model: its query heads and vocabulary
as released, not the port's padded ones, so padding shows as waste.
Attention counts 4·Dh operations per (query, key) pair (QK and PV) over
the keys a causal query needs; a kernel's bytes count each input read
once and each output written once (bf16). The peaks are NVIDIA's data
sheet for the H100 SXM (dense bf16, HBM3), the rates ``chip_smoke.py``'s
``bound()`` uses.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12        # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12       # HBM3, H100 SXM
BF16 = 2


@dataclass(frozen=True)
class Arch:
    """The published sizes a count needs; the dense family's ``counts``."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    @classmethod
    def of(cls, config: dict) -> "Arch":
        return cls(layers=config["num_hidden_layers"],
                   d_model=config["hidden_size"],
                   heads=config["num_attention_heads"],
                   kv_heads=config["num_key_value_heads"],
                   head_dim=config["head_dim"],
                   d_ff=config["intermediate_size"],
                   vocab=config["vocab_size"])

    @property
    def layer_weights(self) -> int:
        """Multiply-accumulate weights of one layer per token."""
        D, H, KV, Dh, F = (self.d_model, self.heads, self.kv_heads,
                           self.head_dim, self.d_ff)
        return D * H * Dh + 2 * D * KV * Dh + H * Dh * D + 3 * D * F

    def attn_pair_flops(self) -> int:
        """Operations of one (query, key) pair in one layer."""
        return 4 * self.heads * self.head_dim

    def chunk_flops(self, lo: int, hi: int, last: bool) -> float:
        return chunk_flops(self, lo, hi, last)

    def decode_flops(self, batch: int, keys: int) -> float:
        return decode_flops(self, batch, keys)


def causal_pairs(lo: int, hi: int) -> int:
    """(query, key) pairs of causal queries at positions [lo, hi)."""
    return (hi * (hi + 1) - lo * (lo + 1)) // 2


def chunk_flops(a: Arch, lo: int, hi: int, last: bool) -> float:
    """A prefill chunk over positions [lo, hi): every layer, and the
    unembedding of the prompt's last position when ``last``."""
    n = hi - lo
    f = 2.0 * n * a.layers * a.layer_weights
    f += a.layers * a.attn_pair_flops() * causal_pairs(lo, hi)
    if last:
        f += 2.0 * a.d_model * a.vocab
    return f


def decode_flops(a: Arch, batch: int, keys: int) -> float:
    """A decode step over ``batch`` slots attending ``keys`` keys in all
    (each slot's depth after its new token, summed)."""
    f = 2.0 * batch * (a.layers * a.layer_weights + a.d_model * a.vocab)
    return f + a.layers * a.attn_pair_flops() * keys


def bound_s(flops: float, n_bytes: float) -> float:
    """Least time on the card: the larger of the two roofs."""
    return max(flops / PEAK_FLOPS, n_bytes / PEAK_BYTES)


def flash_prefill_call(a: Arch, lo: int, hi: int) -> tuple[float, float]:
    """One layer's prefill attention: queries [lo, hi) over keys [0, hi)."""
    n = hi - lo
    flops = a.attn_pair_flops() * causal_pairs(lo, hi)
    n_bytes = BF16 * (2 * n * a.heads * a.head_dim
                      + 2 * hi * a.kv_heads * a.head_dim)
    return flops, n_bytes


def paged_attention_call(a: Arch, batch: int, keys: int) -> tuple[float, float]:
    """One layer's paged decode attention over ``batch`` slots and
    ``keys`` cached keys in all."""
    flops = a.attn_pair_flops() * keys
    n_bytes = BF16 * (2 * batch * a.heads * a.head_dim
                      + 2 * keys * a.kv_heads * a.head_dim)
    return flops, n_bytes
