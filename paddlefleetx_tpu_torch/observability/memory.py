"""Device-memory telemetry: HBM watermarks (the port's counterpart of
the JAX package's ``observability/memory.py``).

The CUDA caching allocator's ``torch.cuda.memory_stats`` and
``torch.cuda.mem_get_info`` are distilled to the JAX module's
keys: ``bytes_in_use`` (``allocated_bytes.all.current``),
``peak_bytes_in_use`` (``allocated_bytes.all.peak``), ``bytes_limit``
(the card's total memory) and ``largest_alloc_size`` (the largest
segment the caching allocator holds, from ``torch.cuda.memory_snapshot``,
as ``memory_stats`` has no such entry; left out while it holds none).
The CPU keeps no such stats and returns None. Sampling happens at logging-window edges,
a host call a window, never a step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The HBM-watermark keys of ``device`` (a CUDA device, the current
    one by default), or None on the CPU or when the allocator is
    unreachable. Never raises: telemetry must not kill the run it
    observes."""
    try:
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        stats = torch.cuda.memory_stats(dev)
        _free, total = torch.cuda.mem_get_info(dev)
        out = {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                             0)),
               "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                                  0)),
               "bytes_limit": int(total)}
        segments = [s["total_size"] for s in torch.cuda.memory_snapshot()
                    if s.get("device") == (dev.index or 0)] \
            if stats.get("segment.all.current", 0) else []
        if segments:
            out["largest_alloc_size"] = int(max(segments))
    except Exception:  # noqa: BLE001 -- telemetry never raises
        return None
    return out


def format_bytes(n: Any) -> str:
    """A human HBM figure (``"3.42G"``); ``"?"`` for a missing value."""
    if not isinstance(n, (int, float)):
        return "?"
    return f"{n / 2**30:.2f}G"
