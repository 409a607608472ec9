"""Jamba-1.5-large 398B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    kind="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attn_every=8,  # 1 attention layer per 8 (1:7 mamba:attn interleave)
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                  parallelism="ep", every=2),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
    rope_theta=1e6,
    optimizer="adafactor",
    source="arXiv:2403.19887 (assignment: 72L d8192 64H kv8 1:7 16e top-2)",
))
