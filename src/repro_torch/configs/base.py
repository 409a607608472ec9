"""Model configuration for the PyTorch port (own copy of the reference's
``repro/configs/base.py``: every family's fields and derived counts,
and the training fields ``optimizer`` and ``remat``).

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
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # 'ep': experts sharded over the model axis (requires n_experts % 16 == 0)
    # 'tp': expert hidden dim sharded over the model axis (few-expert models)
    # (read by the sharded MoE dispatch, models/layers.py _moe_mesh)
    parallelism: str = "ep"
    # apply MoE every k-th layer (1 = all layers); others use dense MLP
    every: int = 1


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 mixer shape. One B/C group: the only one the reference's
    configs use and the port's mixer and SSD kernel take, so any other
    ``n_groups`` is refused."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256  # SSD chunk length

    def __post_init__(self) -> None:
        if self.n_groups != 1:
            raise ValueError(f"n_groups={self.n_groups}: the port's Mamba2 "
                             f"mixer has one B/C group")

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
    kind: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    qk_norm: bool = False
    attn_bias: bool = False
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 1e6
    # --- hybrid (jamba) ---
    attn_every: int = 0  # 1 attention layer per `attn_every` layers; rest SSM
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    cross_attention: bool = False
    # --- modality frontend stub ---
    frontend: str = "none"  # none | patch | audio
    frontend_tokens: int = 0  # patches / audio frames the stub supplies
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_decode_len: int = 0  # architectural cap on decoder length (whisper)
    optimizer: str = "adamw"  # adamw | adafactor (huge archs)
    #: recompute each layer's activations in the backward pass
    #: (``torch.utils.checkpoint``; the reference's ``jax.checkpoint``)
    remat: bool = True
    source: str = ""

    @property
    def padded_heads(self) -> int:
        return _pad_to(self.n_heads, MODEL_AXIS)

    @property
    def padded_vocab(self) -> int:
        return _pad_to(self.vocab_size, 256)

    @property
    def kv_shardable(self) -> bool:
        return self.n_kv_heads % MODEL_AXIS == 0

    @property
    def is_attention_free(self) -> bool:
        return self.kind == "ssm"

    @property
    def attention_layers(self) -> int:
        """Number of layers that carry a KV cache."""
        if self.kind == "ssm":
            return 0
        if self.attn_every:
            return self.n_layers // self.attn_every
        return self.n_layers

    def param_count(self) -> int:
        """Approximate total parameter count — the reference's formula
        (what the cost model prices)."""
        d, L = self.d_model, self.n_layers
        n = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_attn = (d * self.padded_heads * self.head_dim) * 2 \
            + (d * self.n_kv_heads * self.head_dim) * 2
        per_mlp = 3 * d * self.d_ff
        per_ssm = 0
        if self.ssm is not None:
            s = self.ssm
            di, nh = s.d_inner(d), s.n_heads(d)
            per_ssm = d * (2 * di + 2 * s.d_state + nh) + di * d \
                + s.d_conv * s.conv_channels(d) + 3 * nh + di
        # FFN stack (moe-every-k layers use experts, the rest a dense
        # MLP); a pure SSM stack has none
        if self.kind == "ssm":
            ffn = 0
        elif self.moe is not None:
            per_moe = 3 * d * self.moe.d_ff_expert * self.moe.n_experts \
                + d * self.moe.n_experts
            n_moe_layers = L // self.moe.every
            ffn = per_moe * n_moe_layers + per_mlp * (L - n_moe_layers)
        else:
            ffn = per_mlp * L
        # mixer stack
        if self.kind == "ssm":
            mixer = per_ssm * L
        elif self.attn_every:
            n_attn = L // self.attn_every
            mixer = per_attn * n_attn + per_ssm * (L - n_attn)
        else:
            mixer = per_attn * L
        n += mixer + ffn
        # encoder (whisper): self-attention + MLP per encoder layer, and
        # the decoder's cross-attention projections
        if self.encoder_layers:
            n += self.encoder_layers * (per_attn + per_mlp)
            n += L * per_attn
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: the top-k experts only)."""
        full = self.param_count()
        if self.moe is None:
            return full
        n_moe_layers = self.n_layers // self.moe.every
        per_expert = 3 * self.d_model * self.moe.d_ff_expert * n_moe_layers
        return full - per_expert * (self.moe.n_experts - self.moe.top_k)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant, identical to the reference's ``reduced()``:
        2 layers (a hybrid: one full period), d_model ≤ 256, 4 query heads
        (padded to 16), head_dim 32, vocab 512; 2 encoder layers and at
        most 16 frontend tokens; MoE shrinks to 4 experts, top-2,
        d_ff_expert 128 at capacity factor 2.0; an SSM mixer to d_state
        16, head_dim 16, chunk 32; a sliding window to 64; no remat and
        AdamW."""
        d = min(self.d_model, 256)
        kw: dict = dict(
            name=self.name + "-reduced",
            n_layers=2 if not self.attn_every else self.attn_every,
            d_model=d,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=max(128, d * 2),
            vocab_size=512,
            frontend_tokens=min(self.frontend_tokens, 16),
            encoder_layers=2 if self.encoder_layers else 0,
            remat=False,
            optimizer="adamw",
        )
        if self.moe is not None:
            # capacity_factor E/k ⇒ cap == T: drop-free routing, so
            # incremental decode ≡ full prefill exactly (production
            # configs keep 1.25 — capacity drops are real MoE behaviour)
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=128,
                capacity_factor=2.0)
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
    for mod in ("qwen3_moe_235b_a22b", "smollm_360m", "qwen2_5_3b",
                "mixtral_8x7b", "phi3_mini_3_8b", "internvl2_26b",
                "mamba2_2_7b", "whisper_large_v3", "jamba_1_5_large_398b",
                "qwen3_14b", "llama2_70b"):
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
