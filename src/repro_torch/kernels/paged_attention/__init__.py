"""Paged decode attention: CUDA kernel, plain version, dispatcher."""
