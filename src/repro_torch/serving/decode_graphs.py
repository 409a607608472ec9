"""The paged decode step replayed as CUDA graphs, one per block-table width.

Enqueued eagerly, a step of a 32- or 40-layer model costs the host some
2,500 launches, far longer than the card takes to run them. Captured once
per table width, the same operations on the same tensors replay in one
launch. A graph reads fixed addresses, so the step's inputs live in
static buffers, which each step fills first: the host tables' snapshot
through pinned host buffers, the tokens device to device.

``DecodeGraphs`` keeps the per-width bookkeeping and those copies; how a
graph is made is its ``capture`` object's: ``CudaCapture`` on the card,
a stand-in in the CPU tests. ``DecodeWorker`` (``serving/engine.py``)
decides where the graphs are used."""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.paged_attention.kernel import paged_attention


class CudaCapture:
    """Eager warm-up and capture on one side stream; every width's graph
    allocates from one shared memory pool (no two widths ever replay at
    once)."""

    def __init__(self, device) -> None:
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def _on_side(self, fn):
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = fn()
        main.wait_stream(self.stream)
        return out

    def warm(self, fn):
        """Run ``fn`` eagerly on the capture stream: it builds whatever the
        step makes lazily there (cached head maps, the libraries' per-stream
        workspaces), which a capture could not."""
        return self._on_side(fn)

    def capture(self, fn):
        """Capture ``fn`` → (replay, its static outputs). Thread-local
        capture: a copy or synchronise on another thread (a prefetcher, a
        profiler) neither voids the capture nor fails."""
        graph = torch.cuda.CUDAGraph()

        def captured():
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                return fn()
            finally:
                graph.capture_end()
        return graph.replay, self._on_side(captured)


class DecodeGraphs:
    """One graph of ``step`` per block-table width, over static inputs.

    ``step(tokens (B, 1) int64, block_table (B, w) int32, seq_lens (B,)
    int32)`` returns a tuple of tensors; width w's graph replays it on
    the same static tensors and rewrites the same outputs. A width is
    captured the first time a step needs it: that step runs eagerly
    (``capture.warm``), which serves it, and is then captured; later
    steps of the width replay. ``choose_splits`` is a function of shapes
    alone, so the kernel splits each width as the eager step would."""

    def __init__(self, step, max_batch: int, max_pages: int, device,
                 capture) -> None:
        self.step = step
        self.capture = capture
        B = max_batch
        self.tokens = torch.zeros((B, 1), dtype=torch.int64, device=device)
        self.seq_lens = torch.zeros(B, dtype=torch.int32, device=device)
        # one flat table: width w reads its first B·w entries as a
        # contiguous (B, w) view, the layout the kernel takes
        self._table = torch.zeros(B * max_pages, dtype=torch.int32,
                                  device=device)
        pin = torch.device(device).type == "cuda"
        self._host_table = torch.zeros(B * max_pages, dtype=torch.int32,
                                       pin_memory=pin)
        self._host_lens = torch.zeros(B, dtype=torch.int32, pin_memory=pin)
        self._graphs: dict = {}      # width → (replay, static outputs)
        self._launches: dict = {}    # width → kernel launches a replay makes

    def table(self, width: int) -> torch.Tensor:
        B = self.tokens.shape[0]
        return self._table[:B * width].view(B, width)

    def load(self, tokens: torch.Tensor, table: np.ndarray,
             lens: np.ndarray) -> None:
        """Copy one step's inputs into the static buffers, on the current
        stream. The host arrays are copied into the pinned buffers first,
        so later host mutation (growth, copy-on-write, lengths) cannot
        reach the step. Every step ends copying its tokens to the host, a
        synchronise, so no copy out of the pinned buffers is still in
        flight when the next step rewrites them."""
        B, w = table.shape
        n = B * w
        self._host_table[:n].numpy().reshape(B, w)[:] = table
        self._host_lens.numpy()[:] = lens
        self._table[:n].copy_(self._host_table[:n], non_blocking=True)
        self.seq_lens.copy_(self._host_lens, non_blocking=True)
        self.tokens.copy_(tokens)

    def run(self, width: int) -> tuple[tuple, bool]:
        """The loaded step at ``width``: (its outputs, whether they come
        from a replay). A replay's outputs are the graph's own tensors,
        rewritten by its next replay."""
        if width in self._graphs:
            replay, outs = self._graphs[width]
            replay()
            paged_attention.launches += self._launches[width]
            return outs, True
        fn = functools.partial(self.step, self.tokens, self.table(width),
                               self.seq_lens)
        outs = self.capture.warm(fn)
        n0 = paged_attention.launches
        self._graphs[width] = self.capture.capture(fn)
        # a capture launches nothing on the card: each replay launches
        # what the capture recorded
        self._launches[width] = paged_attention.launches - n0
        paged_attention.launches = n0
        return outs, False
