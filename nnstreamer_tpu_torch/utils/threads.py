"""Joinable worker-thread tracking (shared by the socket servers and the
pipeline error-halt path).

Accept loops and error paths spawn short-lived worker threads; leaving
them untracked means stop() cannot join them (a daemon leak the test
suite's thread_leak_check flags). Every owner used to hand-roll the same
prune-and-append / swap-and-join pair — this is that pattern, once.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

from ..analysis import sanitizer as _san


class ThreadRegistry:
    """Tracks STARTED worker threads so a stop() path can join them.

    ``track`` prunes finished threads as it appends, so long-lived
    owners don't accumulate dead entries; ``drain`` swaps the list out
    under the lock and joins outside it (the workers may need locks of
    their own to finish). Call ``track`` only after ``Thread.start()``
    — joining a never-started thread raises RuntimeError.

    A per-thread ``closer`` (socket close/shutdown) runs BEFORE the
    joins on drain — the canonical way to wake a connection handler
    parked in a blocking recv. Closers must be idempotent; a pruned
    dead thread's closer runs at prune time (its socket is done).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # (thread, optional wake/close callable)   guarded-by: _lock
        self._entries: List[Tuple[threading.Thread,
                                  Optional[Callable[[], None]]]] = []

    @staticmethod
    def _close(closer: Optional[Callable[[], None]]) -> None:
        if closer is None:
            return
        try:
            closer()
        except OSError:
            pass

    def track(self, t: threading.Thread,   # pairs-with: drain
              closer: Optional[Callable[[], None]] = None) -> None:
        dead: List[Tuple[threading.Thread,
                         Optional[Callable[[], None]]]] = []
        with self._lock:
            live = []
            for entry in self._entries:
                if entry[0].is_alive():
                    live.append(entry)
                else:
                    dead.append(entry)
            live.append((t, closer))
            self._entries = live
        if _san.LEAK:
            _san.note_acquire("tracked_thread",
                              f"{id(self):x}:{id(t):x}", detail=t.name)
            for dt, _c in dead:
                _san.note_release("tracked_thread",
                                  f"{id(self):x}:{id(dt):x}")
        for _t, closer_fn in dead:
            self._close(closer_fn)

    def drain(self, timeout_per: float = 1.0) -> List[threading.Thread]:
        """Run every closer (wakes parked workers), then join every
        tracked thread (bounded per thread; the current thread is
        skipped so a worker can drain its own registry). Returns the
        STRAGGLERS — threads still alive after their join timeout — so
        the owner can surface them (a silent ``join(timeout=)`` that
        never checks ``is_alive()`` hides a stuck worker forever)."""
        with self._lock:
            entries, self._entries = self._entries, []
        if _san.LEAK:
            # the entries left the registry: whatever survives the joins
            # below is the CALLER's straggler report, not a ledger leak
            for t, _closer in entries:
                _san.note_release("tracked_thread",
                                  f"{id(self):x}:{id(t):x}")
        for _t, closer in entries:
            self._close(closer)
        me = threading.current_thread()
        stragglers: List[threading.Thread] = []
        for t, _closer in entries:
            if t is me:
                continue
            t.join(timeout=timeout_per)
            if t.is_alive():
                stragglers.append(t)
        return stragglers
