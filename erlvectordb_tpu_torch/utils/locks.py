"""Reader-writer lock for store device-array access.

Insert/delete scatters DONATE the store's device buffers (zero-copy
in-place updates); a search that still holds a reference to the donated
buffer would read deleted memory.  Searches therefore take the read side
(many concurrently — unlike the reference, which serializes every query
through one gen_server), while mutations take the exclusive write side.
Writer-preference keeps bulk loads from starving behind a search storm.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()
