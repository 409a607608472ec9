"""Chunked-prefill flash attention: CUDA kernel, plain version, dispatcher."""
