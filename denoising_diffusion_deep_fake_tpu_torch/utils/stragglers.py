"""Bounded atexit cleanup of abandoned worker threads.

Port of ``denoising_diffusion_deep_fake_tpu/utils/stragglers.py`` (the
port keeps its own copy). Error-path teardown (``LoopContext.abort``, a
consumer abandoning a loader's prefetch or ``device_prefetch``) stops its
worker thread with an event and a short bounded join. A worker in the
middle of a transfer (a panel fetch, a pinned upload) can outlive that
join; at interpreter finalization CPython then ends the daemon thread
inside native frames. The registry gives such threads one more bounded
chance to finish before finalization: ``atexit`` callbacks run after the
main thread ends but before daemon threads are torn down, so a join that
completes here exits the thread through normal Python frames. A thread
still alive after the budget is reported and left to its fate.
"""
from __future__ import annotations

import atexit
import sys
import threading
import time

_LOCK = threading.Lock()
_THREADS: list[threading.Thread] = []
_registered = False


def adopt(thread: threading.Thread) -> None:
    """Register a possibly-mid-transfer thread for a final atexit join."""
    global _registered
    with _LOCK:
        if not _registered:
            atexit.register(drain)
            _registered = True
        _THREADS.append(thread)


def drain(budget_s: float = 60.0) -> bool:
    """Join adopted threads within one shared budget; True if all exited.

    Runs automatically at interpreter exit once ``adopt`` has been called;
    callable directly by entry points that want to flush earlier (tests,
    bench tools between rows).
    """
    with _LOCK:
        threads, _THREADS[:] = list(_THREADS), []
    deadline = time.monotonic() + budget_s
    ok = True
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            ok = False
            print(f"WARNING: abandoned transfer thread {t.name!r} still "
                  "alive at exit (device link stuck?)",
                  file=sys.stderr, flush=True)
    return ok
