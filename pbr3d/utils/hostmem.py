"""Host-memory tuning against page-fault stalls on large temporaries.

glibc returns every free >=128 KB to the kernel via munmap, so each large
numpy temporary re-faults its pages — repeated ~100 MB temporaries in the
carving/stats host loops pay first-touch page faults on every use, which
is slow on hosts under memory overcommit.

``keep_host_heap`` raises the malloc mmap/trim thresholds so large blocks
come from the persistent heap and freed pages are NOT returned — the
process faults each page once and reuses it thereafter.  Memory cost is the
high-water mark of concurrently-live big allocations (hundreds of MB).
Opt out with ``PBR3D_MALLOPT=0``.
"""

from __future__ import annotations

import ctypes
import os

_done = False

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def keep_host_heap(threshold: int = 1 << 30) -> bool:
    """Keep big allocations heap-resident (idempotent).  Returns True if
    the mallopt calls were applied."""
    global _done
    if _done or os.environ.get("PBR3D_MALLOPT", "1") == "0":
        return False
    _done = True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, threshold)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, threshold)
        return bool(ok1 and ok2)
    except Exception:  # non-glibc platforms: a no-op is fine
        return False
