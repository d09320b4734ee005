"""Launch counters of the kernel wrappers, safe across threads.

Each wrapper keeps its counts as plain integer attributes of its public
function (`log_mel_frames.launches`, `flash_attention.fwd_launches`, ...),
which callers read and reset by assignment. `+= 1` on such an attribute is
a read, an add and a write, and the serving daemon (seld_tpu_torch.serve)
launches kernels from several threads at once: the connection threads K1
or K4, the batcher's thread K3. So every wrapper adds through `bump`,
under one lock.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def bump(fn, name: str = "launches") -> None:
    """Add one to the counter `name` of the wrapper function `fn`."""
    with _LOCK:
        setattr(fn, name, getattr(fn, name) + 1)
