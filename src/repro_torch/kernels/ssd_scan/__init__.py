"""Chunked SSD scan (Mamba2): CUDA kernel, its plain version, the op."""
