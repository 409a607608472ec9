"""Qwen2.5-3B (GQA, QKV bias). [hf:Qwen/Qwen2.5-0.5B family]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    kind="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    attn_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B (assignment: 36L d2048 16H kv2 bias)",
))
