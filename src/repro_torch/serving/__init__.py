"""Serving engines of the port: paged device KV, chunked prefill, continuous batching."""
