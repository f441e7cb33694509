"""Launch counts of the CUDA kernel wrappers.

Each wrapper (`tucker_kernel.tucker2_factors_batched`,
`subspace_kernel.dominant_left_subspace_batched`) counts its kernel's
launches in its `launches` attribute. A launch issued while the current
stream captures a CUDA graph runs nothing then; it is counted in the
wrapper's `captured` attribute instead, and `train/capture.py` adds the
launches a graph captured to `launches` at every replay of that graph.
"""

from __future__ import annotations

import torch


def count_launch(wrapper) -> None:
    """One launch of `wrapper`'s kernel, at the call or, under capture, at
    each replay of the graph."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured = getattr(wrapper, "captured", 0) + 1
    else:
        wrapper.launches += 1
