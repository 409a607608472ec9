"""Chunked SSD scan (Mamba2): CUDA kernel, its plain version, the op."""
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_naive_ref, ssd_scan_ref
