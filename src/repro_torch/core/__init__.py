"""Host-side scheduling pieces copied from the reference (jax-free)."""
