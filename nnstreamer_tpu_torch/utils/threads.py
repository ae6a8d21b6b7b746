"""Joinable worker-thread tracking (the pipeline error-halt path).

Error paths spawn short-lived worker threads; leaving them untracked means
stop() cannot join them. This is the prune-and-append / swap-and-join pair,
once.
"""
from __future__ import annotations

import threading
from typing import List


class ThreadRegistry:
    """Tracks STARTED worker threads so a stop() path can join them.

    ``track`` prunes finished threads as it appends, so long-lived owners
    don't accumulate dead entries; ``drain`` swaps the list out under the
    lock and joins outside it (the workers may need locks of their own to
    finish). Call ``track`` only after ``Thread.start()`` — joining a
    never-started thread raises RuntimeError.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []  # guarded-by: _lock

    def track(self, t: threading.Thread) -> None:
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()] + [t]

    def drain(self, timeout_per: float = 1.0) -> List[threading.Thread]:
        """Join every tracked thread (bounded per thread; the current thread
        is skipped so a worker can drain its own registry). Returns the
        STRAGGLERS — threads still alive after their join timeout."""
        with self._lock:
            threads, self._threads = self._threads, []
        me = threading.current_thread()
        stragglers: List[threading.Thread] = []
        for t in threads:
            if t is me:
                continue
            t.join(timeout=timeout_per)
            if t.is_alive():
                stragglers.append(t)
        return stragglers
