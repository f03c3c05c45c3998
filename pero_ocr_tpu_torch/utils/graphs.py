"""Capture of a fixed-shape device loop as one CUDA graph.

The decode loops of the port (the beam search with its LM, the
transformer's greedy and beam decodes) launch hundreds of small kernels
a step; the JAX package compiles each into one XLA program.  On the
card each decode shape is captured once and replayed.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch


def capture(fn: Callable[[], Any], device: torch.device, what: str) -> Tuple[Any, Any]:
    """``fn`` (which reads and writes only static device buffers) run
    once eagerly on a side stream, as capture requires (cuBLAS and
    allocator warm-up), with synchronising ops raising
    (``set_sync_debug_mode("error")``), then captured.  Returns (the
    graph, the outputs its replays write).  A step that cannot be
    captured raises RuntimeError naming ``what``."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    debug_mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(stream):
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(debug_mode)
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    except RuntimeError as e:
        raise RuntimeError(f"{what} cannot be captured in a CUDA graph: {e}") from e
    torch.cuda.synchronize(device)
    return graph, out
