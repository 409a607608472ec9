"""LLaMA2-70B — the paper's own dummy evaluation model (§8.1). The
Conductor's cost model prices requests against it."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama2-70b",
    kind="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32000,
    rope_theta=1e4,
    optimizer="adafactor",
    source="arXiv:2307.09288 (Mooncake §8.1 dummy model)",
))
