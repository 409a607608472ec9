"""Model configuration for the PyTorch port (own copy of the reference's
``repro/configs/base.py``, cut to what the ported dense and SSM serving
paths read).

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
    """Per-serving-instance KVCache storage hierarchy (Mooncake §3:
    "the underutilized CPU, DRAM and SSD resources of the GPU cluster").

    ``ssd_blocks = 0`` disables the SSD tier (flat DRAM pool); ``None``
    capacities mean unbounded. ``ssd_dir`` makes the serving engine's SSD
    tier real: ``HostKVPool`` backs it with a checksummed file store
    (``serving/ssd_store.py``) in that directory and prefetches demoted
    blocks asynchronously.
    """
    dram_blocks: Optional[int] = 20_000
    ssd_blocks: Optional[int] = 0
    dram_policy: str = "lru"
    ssd_policy: str = "lru"
    writeback_batch: int = 8   # demotions per batched SSD write
    ssd_dir: Optional[str] = None   # file-backed store location (engine)

    @property
    def tiered(self) -> bool:
        return self.ssd_blocks is None or self.ssd_blocks > 0

    def make_pool(self, block_bytes: int = 0):
        """Build the matching metadata pool (flat or tiered)."""
        from repro_torch.core.cache import CachePool
        from repro_torch.core.tiered import TieredCachePool
        if not self.tiered:
            return CachePool(self.dram_blocks, self.dram_policy,
                             block_bytes=block_bytes)
        return TieredCachePool(
            self.dram_blocks, self.ssd_blocks,
            policy=self.dram_policy, ssd_policy=self.ssd_policy,
            block_bytes=block_bytes, writeback_batch=self.writeback_batch)


@dataclass(frozen=True)
class ClusterSpec:
    """A serving scenario as data: pool sizes, SLOs, cache hierarchy and
    the scheduling policies (by registry name) of one ``MooncakeCluster``
    (``core/simulator.py``). ``strategy`` / ``admission`` /
    ``decode_policy`` resolve through ``repro_torch.core.policies`` — any
    registered name, user policies included.

    ``inst_spec`` is a ``repro_torch.core.costmodel.InstanceSpec``;
    ``None`` means the default one, an 8-GPU H100 node. Typed loosely to
    keep configs import-light.
    """
    n_prefill: int = 4
    n_decode: int = 4
    ttft_slo: float = 30.0
    tbt_slo: float = 0.1
    cache: CacheTierSpec = CacheTierSpec()
    strategy: str = "kvcache"
    admission: str = "early"
    decode_policy: str = "min_tbt"
    balancing_threshold: float = 1.3
    layerwise_prefill: bool = True
    #: share one GlobalBlockDirectory across prefill pools (the Figure-3
    #: cluster-wide pool: demoted blocks become peer-SSD-fetchable). Only
    #: meaningful when the cache is tiered; flat pools have no SSD tier.
    global_pool: bool = True
    t_d: float = 10.0              # predictive admission's uniform decode time
    seed: int = 0
    inst_spec: Optional[object] = None

    def replace(self, **kw) -> "ClusterSpec":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 mixer shape (one B/C group, the only one the reference's
    configs use and the SSD kernel takes)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_channels(self, d_model: int) -> int:
        """Channels of the causal conv: x, B and C."""
        return self.d_inner(d_model) + 2 * self.d_state


@dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str  # dense | ssm (the families this package serves so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    ssm: Optional[SSMConfig] = None
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

    @property
    def is_attention_free(self) -> bool:
        return self.kind == "ssm"

    @property
    def attention_layers(self) -> int:
        """Number of layers that carry a KV cache."""
        return 0 if self.kind == "ssm" else self.n_layers

    def param_count(self) -> int:
        """Approximate total parameter count — the reference's formula for
        the dense and SSM families (what the cost model prices); the MoE,
        hybrid and encoder terms come with those families."""
        d, L = self.d_model, self.n_layers
        n = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.kind == "ssm":
            s = self.ssm
            di, nh = s.d_inner(d), s.n_heads(d)
            per_ssm = d * (2 * di + 2 * s.d_state + nh) + di * d \
                + s.d_conv * s.conv_channels(d) + 3 * nh + di
            return n + per_ssm * L
        per_attn = (d * self.padded_heads * self.head_dim) * 2 \
            + (d * self.n_kv_heads * self.head_dim) * 2
        per_mlp = 3 * d * self.d_ff
        return n + (per_attn + per_mlp) * L

    def active_param_count(self) -> int:
        """Activated params per token: all of them for dense and SSM."""
        return self.param_count()

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant, identical to the reference's ``reduced()``
        for dense and SSM configs: 2 layers, d_model ≤ 256, 4 query heads
        (padded to 16), head_dim 32, vocab 512; an SSM mixer shrinks to
        d_state 16, head_dim 16, chunk 32."""
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
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=32)
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


def list_configs() -> list[str]:
    """The registered config names, sorted."""
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in ("smollm_360m", "qwen2_5_3b", "mamba2_2_7b", "llama2_70b"):
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
