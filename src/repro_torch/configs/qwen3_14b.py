"""Qwen3-14B (qk_norm, GQA). [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-14b",
    kind="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (assignment: 40L d5120 40H kv8 qk_norm)",
))
