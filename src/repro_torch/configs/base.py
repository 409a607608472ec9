"""Model configuration for the PyTorch port (own copy of the reference's
``repro/configs/base.py``, cut to what the serving main path reads).

Derived quantities, as in the reference:
  * ``padded_heads`` — query heads padded up to a multiple of 16
    (``MODEL_AXIS``). Padded heads have zero ``wq`` columns; they still
    attend (uniformly, over KV head 0) and pass through ``wo``.
  * ``padded_vocab`` — vocab padded to a multiple of 256.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

MODEL_AXIS = 16  # query-head padding multiple (the reference's TP degree)


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class CacheTierSpec:
    """Per-serving-instance KVCache storage: the DRAM tier only. The SSD
    tier (``ssd_blocks > 0``) is not ported yet and is refused."""
    dram_blocks: Optional[int] = 20_000
    ssd_blocks: Optional[int] = 0

    @property
    def tiered(self) -> bool:
        return self.ssd_blocks is None or self.ssd_blocks > 0

    def make_pool(self):
        from repro_torch.core.cache import CachePool
        if self.tiered:
            raise NotImplementedError(
                "the SSD tier is not ported to repro_torch yet; use "
                "ssd_blocks=0 (flat DRAM pool)")
        return CachePool(self.dram_blocks)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str  # dense (the only family this package serves so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    attn_bias: bool = False
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    source: str = ""

    @property
    def padded_heads(self) -> int:
        return _pad_to(self.n_heads, MODEL_AXIS)

    @property
    def padded_vocab(self) -> int:
        return _pad_to(self.vocab_size, 256)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant, identical to the reference's ``reduced()``
        for dense configs: 2 layers, d_model ≤ 256, 4 query heads (padded
        to 16), head_dim 32, vocab 512."""
        d = min(self.d_model, 256)
        kw: dict = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=max(128, d * 2),
            vocab_size=512,
        )
        if self.sliding_window:
            kw["sliding_window"] = 64
        return dataclasses.replace(self, **kw)


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in ("smollm_360m", "qwen2_5_3b"):
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
