"""The process's host allocator policy for the BatchedFHE parties' frames.

``keep_freed_host_memory`` is called once per process, where a party is
constructed (``protocol/batched_fhe.py``), never by the wire layer."""

from __future__ import annotations

# glibc's mallopt parameters
_M_TRIM_THRESHOLD, _M_TOP_PAD, _M_MMAP_THRESHOLD = -1, -2, -3
_heap_kept = False


def keep_freed_host_memory() -> None:
    """Serve the frames' host buffers from heap memory that stays mapped.

    Every frame allocates and frees host buffers of its own size each
    exchange (the download, its bytes, the frame around them, the copy on
    the way back up: 19 MB each for BFV's index ciphertexts at the 2^20
    row). glibc's malloc maps a buffer above its mmap threshold (128 KiB,
    raised only as mapped blocks are freed) afresh and returns freed heap
    memory above its trim threshold to the system, so each exchange faulted
    its frames in page by page, unless earlier host work happened to have
    grown the heap. With the mmap threshold at 32 MiB (glibc's largest), a
    1 GiB trim threshold and 128 MiB of top pad, buffers up to 32 MiB are
    carved from heap memory that stays mapped; larger frames (the 2^24
    row's 72 MiB index) are still mapped afresh. Once per process; nothing
    where the C library has no ``mallopt``."""
    global _heap_kept
    if _heap_kept:
        return
    _heap_kept = True
    import ctypes

    mallopt = getattr(ctypes.CDLL(None), "mallopt", None)
    if mallopt is not None:
        for param, value in ((_M_MMAP_THRESHOLD, 32 << 20), (_M_TRIM_THRESHOLD, 1 << 30),
                             (_M_TOP_PAD, 128 << 20)):
            mallopt(param, value)
