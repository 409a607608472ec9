"""Paged decode attention: CUDA kernel, plain version, dispatcher."""
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_decode_attention_layers)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_layers_ref, paged_attention_ref,
    paged_attention_split_ref)
