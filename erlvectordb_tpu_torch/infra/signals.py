"""Graceful shutdown engine — priority-ordered callbacks on SIGTERM/SIGINT.

Capability parity with the reference's signal_handler (src/signal_handler.erl):
priority-ordered shutdown callbacks (:33-37, register :118-136); per-callback
timeout = total/N with a 1 s floor (:276-285); default callbacks release
ports first, stop services, then stop the app (:235-252); auto-enabled in
container mode (:75-96).  Signals are trapped with Python's signal module
instead of the reference's spawned-shell ``trap`` port (:199-222).
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Callable, List, Tuple

logger = logging.getLogger("evdb.signals")


class SignalHandler:
    def __init__(self, total_timeout: float = 30.0, install_signals: bool = False):
        self.total_timeout = total_timeout
        self._callbacks: List[Tuple[int, str, Callable[[], None]]] = []
        self._lock = threading.RLock()
        self._shutdown_done = threading.Event()
        self._prev_handlers = {}
        if install_signals:
            self.install()

    def register_callback(self, name: str, fn: Callable[[], None],
                          priority: int = 50) -> None:
        """Lower priority runs first (reference: ports 10, health 20, app 100)."""
        with self._lock:
            self._callbacks = [(p, n, f) for (p, n, f) in self._callbacks if n != name]
            self._callbacks.append((priority, name, fn))
            self._callbacks.sort(key=lambda t: t[0])

    def unregister_callback(self, name: str) -> bool:
        with self._lock:
            before = len(self._callbacks)
            self._callbacks = [(p, n, f) for (p, n, f) in self._callbacks if n != name]
            return len(self._callbacks) != before

    def callbacks(self) -> List[str]:
        with self._lock:
            return [n for (_, n, _) in self._callbacks]

    def install(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                pass  # not the main thread

    def uninstall(self) -> None:
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev_handlers.clear()

    def _on_signal(self, signum, frame):
        logger.info("signal %s: starting graceful shutdown", signum)
        self.shutdown()
        raise SystemExit(0)

    def shutdown(self) -> List[dict]:
        """Run every callback in priority order with per-callback timeouts
        (reference perform_graceful_shutdown :254-285)."""
        if self._shutdown_done.is_set():
            return []
        self._shutdown_done.set()
        with self._lock:
            cbs = list(self._callbacks)
        per_cb = max(self.total_timeout / max(len(cbs), 1), 1.0)
        results = []
        for priority, name, fn in cbs:
            t0 = time.perf_counter()
            done = threading.Event()
            err: List[str] = []

            def runner():
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 — shutdown must proceed
                    err.append(f"{type(e).__name__}: {e}")
                finally:
                    done.set()

            th = threading.Thread(target=runner, daemon=True)
            th.start()
            finished = done.wait(per_cb)
            results.append({
                "callback": name,
                "priority": priority,
                "ok": finished and not err,
                "timed_out": not finished,
                "error": err[0] if err else None,
                "duration_s": round(time.perf_counter() - t0, 3),
            })
            if not finished:
                logger.warning("shutdown callback %s timed out after %.1fs",
                               name, per_cb)
        return results
