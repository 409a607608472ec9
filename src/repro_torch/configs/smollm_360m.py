"""SmolLM-360M (llama-arch small). [hf:HuggingFaceTB/SmolLM-135M family]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-360m",
    kind="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=1e4,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M (assignment: 32L d960 15H kv5)",
))
