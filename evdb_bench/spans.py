"""Harness spans around the program's layer entry points (traced runs).

Installed from the benchmark before the Application starts (the gRPC server
binds its handlers when it starts) and removed after the window; the
program is unchanged.  Times are ``time.perf_counter()`` seconds, the clock
the program's own search tickets carry (``ticket.t0``).

  * ``frontend.grpc``: each gRPC ``SearchBatch`` handler call, with the
    store tickets it submitted;
  * ``frontend.mcp``: each MCP request's synchronous processing
    (``MCPServer._process``; batched searches return once submitted);
  * ``store``: each store search from its submit (``ticket.t0``) to the end
    of its completion, with its query count;
  * ``index``: each ``IndexManager.search`` call.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.spans = defaultdict(list)
        self._tls = threading.local()
        self._undo = []

    def clear(self) -> None:
        self.spans = defaultdict(list)

    def _patch(self, owner, name, make) -> None:
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def install(self) -> "Spans":
        from erlvectordb_tpu_torch.core.index_manager import IndexManager
        from erlvectordb_tpu_torch.core.store import VectorStore
        from erlvectordb_tpu_torch.serve.grpc_server import GrpcServer
        from erlvectordb_tpu_torch.serve.mcp_server import MCPServer

        sp, tls = self, self._tls

        def grpc_batch(orig):
            def wrapper(self, request, context):
                tls.tickets = []
                s = time.perf_counter()
                try:
                    return orig(self, request, context)
                finally:
                    sp.spans["frontend.grpc"].append(
                        (s, time.perf_counter(), tls.tickets))
                    tls.tickets = None
            return wrapper

        def mcp_process(orig):
            def wrapper(self, req, send=None):
                s = time.perf_counter()
                try:
                    return orig(self, req, send)
                finally:
                    sp.spans["frontend.mcp"].append((s, time.perf_counter()))
            return wrapper

        def submit(orig):
            def wrapper(self, *a, **kw):
                t = orig(self, *a, **kw)
                owner = getattr(tls, "tickets", None)
                if owner is not None:
                    owner.append(t)
                return t
            return wrapper

        def complete(orig):
            def wrapper(self, t):
                try:
                    return orig(self, t)
                finally:
                    t.evdb_bench_end = time.perf_counter()
                    sp.spans["store"].append((t.t0, t.evdb_bench_end, t.nq))
            return wrapper

        def index_search(orig):
            def wrapper(self, *a, **kw):
                s = time.perf_counter()
                try:
                    return orig(self, *a, **kw)
                finally:
                    sp.spans["index"].append((s, time.perf_counter()))
            return wrapper

        self._patch(GrpcServer, "SearchBatch", grpc_batch)
        self._patch(MCPServer, "_process", mcp_process)
        self._patch(VectorStore, "search_batch_submit", submit)
        self._patch(VectorStore, "search_batch_complete", complete)
        self._patch(VectorStore, "search_batch_complete_raw", complete)
        self._patch(IndexManager, "search", index_search)
        return self

    def uninstall(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)

    def within(self, name: str, t0: float, t1: float) -> list:
        """The spans of ``name`` that started inside [t0, t1]."""
        return [s for s in self.spans[name] if t0 <= s[0] <= t1]
