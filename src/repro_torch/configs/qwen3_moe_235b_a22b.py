"""Qwen3-MoE 235B-A22B. [hf:Qwen/Qwen3-30B-A3B scaled per assignment]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    kind="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # assignment lists the MoE expert FF width here
    vocab_size=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536, parallelism="ep"),
    qk_norm=True,
    rope_theta=1e6,
    optimizer="adafactor",
    source="hf:Qwen/Qwen3-30B-A3B (assignment: 94L d4096 64H kv4 128e top-8)",
))
