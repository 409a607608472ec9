"""Chunked-prefill flash attention: CUDA kernel, plain version, dispatcher."""
from repro_torch.kernels.flash_prefill.ops import flash_prefill_attention
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
