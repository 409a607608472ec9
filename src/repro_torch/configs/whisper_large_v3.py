"""Whisper-large-v3 — encoder-decoder transformer backbone; mel/conv frontend
is the sanctioned stub supplying frame embeddings. [arXiv:2212.04356]

Simplification, as in the reference: RoPE + RMSNorm are used in place of
Whisper's sinusoidal/learned positions + LayerNorm (dummy-model spirit — the
serving-system behaviour under study does not depend on the norm flavour).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    kind="audio",
    n_layers=32,            # decoder layers
    encoder_layers=32,
    cross_attention=True,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    frontend="audio",
    frontend_tokens=1500,   # encoder frames after the conv stub
    rope_theta=1e4,
    max_decode_len=448,     # architectural cap on the decoder length
    source="arXiv:2212.04356 (assignment: 32L d1280 20H enc-dec, conv stub)",
))
