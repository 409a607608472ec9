"""Phi-3-mini 3.8B (RoPE, SwiGLU, MHA). [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b",
    kind="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=1e4,
    source="arXiv:2404.14219 (assignment: 32L d3072 32H kv32)",
))
