"""Mixtral-8x7B (8 experts top-2, sliding-window attention). [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    kind="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336, parallelism="tp"),
    sliding_window=4096,
    rope_theta=1e6,
    optimizer="adafactor",
    source="arXiv:2401.04088 (assignment: 32L d4096 32H kv8 8e top-2 SWA)",
))
