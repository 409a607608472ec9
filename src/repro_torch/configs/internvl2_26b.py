"""InternVL2-26B language backbone (InternLM2-20B); InternViT frontend is the
sanctioned stub supplying patch embeddings. [arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    kind="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    frontend="patch",
    frontend_tokens=256,  # ViT patch embeddings per image (stub)
    rope_theta=1e6,
    optimizer="adafactor",
    source="arXiv:2404.16821 (assignment: 48L d6144 48H kv8, ViT stub)",
))
