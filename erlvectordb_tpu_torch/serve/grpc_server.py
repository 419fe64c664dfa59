"""gRPC frontend — binary-native serving alongside MCP/TCP and REST.

The reference ships MCP, REST and OAuth frontends only; gRPC is the
rebuild's parity-plus frontend (ROADMAP #13).  Design points:

  * Messages are generated from proto/evdb.proto (``evdb_pb2.py``); the
    SERVICE is registered by hand with
    ``grpc.method_handlers_generic_handler`` — no grpc_tools/stub codegen
    needed, any standard gRPC client in any language works against
    proto/evdb.proto.
  * Query/insert vectors cross the wire as packed little-endian f32 rows
    (``vectors_f32`` + ``dim``) — the binary analogue of the MCP
    ``search_vectors_batch`` b64 fast path, minus the base64 tax.
  * Searches ride the shared :class:`~erlvectordb_tpu_torch.serve.batcher.
    QueryBatcher` pipeline (async dispatch/completion split), so gRPC,
    MCP and REST traffic coalesce into the same device batches.
  * ``StreamSearch`` is a bidirectional stream: requests are submitted as
    they arrive and replies are yielded as device batches complete —
    out-of-order, correlated by the echoed ``seq`` field (the gRPC
    analogue of MCP's pipelined out-of-order JSON-RPC ids).
  * ``CreateStore(distributed=true)`` creates a store sharded over the
    Database's cluster mesh (parallel/).
  * Auth: ``authorization: Bearer <token>`` call metadata, validated
    against the built-in OAuth 2.1 server with the same read/write/admin
    scope classes as the MCP tool table (serve/tools.py,
    reference src/mcp_server.erl:414-427).
  * Spans (utils/metrics.py): every unary call opens a request id in its
    request deserializer and closes ``grpc.request`` when its reply is
    serialized.  grpc-python parses a request on its completion-queue
    polling thread and runs the handler and the serializer on a pool
    thread, so the id rides the parsed request (``_Arrival``) to the pool
    thread, which carries it (``metrics.bind``) to the handler, the batcher
    and the serializer.  ``SearchBatch`` adds ``grpc.decode`` (the protobuf
    parse, then the rows) and ``grpc.encode`` (ids, reply,
    ``SerializeToString``).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from concurrent import futures
from typing import Optional

import numpy as np

from erlvectordb_tpu_torch.serve import tools as tools_mod
from erlvectordb_tpu_torch.utils.metrics import metrics, now_ns

logger = logging.getLogger("evdb.grpc")

try:  # the frontend degrades to disabled when grpcio or protobuf is absent
    import google.protobuf  # noqa: F401 — evdb_pb2's runtime
    import grpc
except ImportError:
    grpc = None

GRPC_AVAILABLE = grpc is not None

# method -> required scope (None = unauthenticated)
_SCOPES = {
    "Health": None,
    "ListStores": "read",
    "Search": "read",
    "SearchBatch": "read",
    "StreamSearch": "read",
    "Stats": "read",
    "CreateStore": "write",
    "DeleteStore": "admin",  # matches MCP delete_store / REST (tools.py)
    "Insert": "write",
    "InsertBatch": "write",
    "Delete": "write",
    "Sync": "write",
    "Backup": "admin",
    "Restore": "admin",
    "ListBackups": "admin",
}


class _Arrival:
    """A parsed request with the id it opened and its parse's clock reads."""
    __slots__ = ("msg", "rid", "t0", "t_parsed")

    def __init__(self, msg, rid: int, t0: int, t_parsed: int):
        self.msg, self.rid, self.t0, self.t_parsed = msg, rid, t0, t_parsed


def _decode_rows(blob: bytes, dim: int) -> np.ndarray:
    if dim <= 0:
        raise ValueError("dim must be positive")
    if len(blob) % (4 * dim) != 0:
        raise ValueError(
            f"vectors_f32 length {len(blob)} is not a multiple of dim*4")
    return np.frombuffer(blob, dtype="<f4").reshape(-1, dim)


class GrpcServer:
    """The ErlVectorDB gRPC service (see proto/evdb.proto)."""

    def __init__(self, db, host: str = "127.0.0.1", port: int = 8083,
                 max_workers: int = 16):
        if grpc is None:
            raise RuntimeError("grpcio is not available")
        from erlvectordb_tpu_torch.serve import evdb_pb2 as pb

        self.pb = pb
        self.db = db
        self.host = host
        self.port = port
        self._server: Optional["grpc.Server"] = None
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="evdb-grpc")
        # the unary call a pool thread serves: its arrival, its queries and
        # where its reply's encoding began (SearchBatch)
        self._call = threading.local()

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "GrpcServer":
        pb = self.pb
        uu = grpc.unary_unary_rpc_method_handler
        ss = grpc.stream_stream_rpc_method_handler

        def h(fn, req_cls, reply_cls, streaming=False):
            if streaming:
                return ss(fn, request_deserializer=req_cls.FromString,
                          response_serializer=reply_cls.SerializeToString)
            return uu(self._entering(fn),
                      request_deserializer=self._opening(req_cls.FromString),
                      response_serializer=self._closing(
                          reply_cls.SerializeToString))

        handlers = {
            "Health": h(self.Health, pb.Empty, pb.HealthReply),
            "ListStores": h(self.ListStores, pb.Empty, pb.ListStoresReply),
            "Search": h(self.Search, pb.SearchRequest, pb.SearchReply),
            "SearchBatch": h(self.SearchBatch, pb.SearchBatchRequest,
                             pb.SearchBatchReply),
            "StreamSearch": h(self.StreamSearch, pb.SearchRequest,
                              pb.SearchReply, streaming=True),
            "Stats": h(self.Stats, pb.StoreRef, pb.StatsReply),
            "CreateStore": h(self.CreateStore, pb.CreateStoreRequest,
                             pb.StatusReply),
            "DeleteStore": h(self.DeleteStore, pb.StoreRef, pb.StatusReply),
            "Insert": h(self.Insert, pb.InsertRequest, pb.StatusReply),
            "InsertBatch": h(self.InsertBatch, pb.InsertBatchRequest,
                             pb.StatusReply),
            "Delete": h(self.Delete, pb.DeleteRequest, pb.StatusReply),
            "Sync": h(self.Sync, pb.StoreRef, pb.StatusReply),
            "Backup": h(self.Backup, pb.BackupRequest, pb.BackupReply),
            "Restore": h(self.Restore, pb.RestoreRequest, pb.StatusReply),
            "ListBackups": h(self.ListBackups, pb.Empty, pb.ListBackupsReply),
        }
        self._server = grpc.server(self._pool)
        self._server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler("evdb.ErlVectorDB", handlers),
        ))
        bound = self._server.add_insecure_port(f"{self.host}:{self.port}")
        if bound == 0:
            raise OSError(f"gRPC could not bind {self.host}:{self.port}")
        self.port = bound
        self._server.start()
        logger.info("gRPC server on %s:%d", self.host, self.port)
        return self

    @staticmethod
    def _opening(parse):
        """The request deserializer, opening the call's id."""
        def deserialize(data):
            t0 = now_ns()
            msg = parse(data)
            return _Arrival(msg, metrics.new_id(), t0, now_ns())
        return deserialize

    def _entering(self, handler):
        """The handler, on its pool thread bound to the call's id."""
        call = self._call

        def behavior(arrival, context):
            call.arrival, call.n, call.t_encode = arrival, 1, None
            metrics.bind(arrival.rid)
            return handler(arrival.msg, context)
        return behavior

    def _closing(self, serialize):
        """The reply serializer, closing the call's spans at its return."""
        call = self._call

        def serialize_traced(reply):
            out = serialize(reply)
            t = now_ns()
            a = getattr(call, "arrival", None)
            if a is not None:
                if call.t_encode is not None:
                    metrics.record("grpc.encode", a.rid, 0, call.t_encode, t,
                                   call.n)
                metrics.record("grpc.request", a.rid, 0, a.t0, t, call.n)
                call.arrival = None
                metrics.bind(0)
            return out
        return serialize_traced

    def stop(self, grace: float = 1.0) -> None:
        if self._server is not None:
            self._server.stop(grace).wait(grace + 1.0)
            self._server = None

    def is_alive(self) -> bool:
        return self._server is not None

    # --------------------------------------------------------------- auth

    def _auth(self, context, method: str) -> None:
        scope = _SCOPES[method]
        if scope is None or not self.db.oauth.enabled:
            return
        token = None
        for k, v in context.invocation_metadata():
            if k.lower() == "authorization" and v.startswith("Bearer "):
                token = v[7:]
        if token is None:
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "missing bearer token")
        info = self.db.oauth.validate_token(token)
        if info is None:
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "invalid or expired token")
        if scope not in info["scopes"]:
            context.abort(grpc.StatusCode.PERMISSION_DENIED,
                          f"scope {scope!r} required")

    def _abort(self, context, e: Exception):
        if isinstance(e, KeyError):
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        if isinstance(e, ValueError):
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        logger.exception("grpc handler error")
        context.abort(grpc.StatusCode.INTERNAL, str(e))

    # ------------------------------------------------------------ handlers

    def Health(self, request, context):
        status = self.db.health_status() if hasattr(self.db, "health_status") \
            else "healthy"
        return self.pb.HealthReply(status=status, detail_json=json.dumps(
            {"stores": len(self.db.list_stores())}))

    def ListStores(self, request, context):
        self._auth(context, "ListStores")
        return self.pb.ListStoresReply(names=self.db.list_stores())

    def Stats(self, request, context):
        self._auth(context, "Stats")
        try:
            return self.pb.StatsReply(
                stats_json=json.dumps(self.db.get_stats(request.name)))
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)

    def CreateStore(self, request, context):
        self._auth(context, "CreateStore")
        try:
            kwargs = {}
            if request.metric:
                kwargs["metric"] = request.metric
            if request.dtype:
                kwargs["dtype"] = request.dtype
            dim = request.dimension or None
            if request.distributed:
                self.db.create_distributed_store(request.name, dim, **kwargs)
            else:
                self.db.create_store(request.name, dim, **kwargs)
            metrics.inc("grpc.create_store")
            return self.pb.StatusReply(ok=True, message=request.name)
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)

    def DeleteStore(self, request, context):
        self._auth(context, "DeleteStore")
        try:
            ok = self.db.delete_store(request.name)
            return self.pb.StatusReply(ok=bool(ok))
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)

    def Insert(self, request, context):
        self._auth(context, "Insert")
        try:
            meta = json.loads(request.metadata_json) \
                if request.metadata_json else None
            self.db.insert(request.store, request.id,
                           np.asarray(request.vector, np.float32), meta)
            metrics.inc("grpc.inserted")
            return self.pb.StatusReply(ok=True)
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)

    def InsertBatch(self, request, context):
        self._auth(context, "InsertBatch")
        try:
            rows = _decode_rows(request.vectors_f32, request.dim)
            if rows.shape[0] != len(request.ids):
                raise ValueError(
                    f"{len(request.ids)} ids but {rows.shape[0]} vector rows")
            metas = None
            if request.metadata_json:
                if len(request.metadata_json) != len(request.ids):
                    raise ValueError("metadata_json count mismatch")
                metas = [json.loads(m) if m else None
                         for m in request.metadata_json]
            self.db.insert_batch(request.store, list(request.ids), rows,
                                 metas)
            metrics.inc("grpc.inserted", rows.shape[0])
            return self.pb.StatusReply(ok=True, message=str(rows.shape[0]))
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)

    def Delete(self, request, context):
        self._auth(context, "Delete")
        try:
            ok = self.db.delete(request.store, request.id)
            return self.pb.StatusReply(ok=bool(ok))
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)

    def Sync(self, request, context):
        self._auth(context, "Sync")
        try:
            self.db.sync(request.name)
            return self.pb.StatusReply(ok=True)
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)

    # ------------------------------------------------------------- search

    def _search_kw(self, request) -> dict:
        """A request's k, metric, filter and probe arguments; proto 3 reads
        0 as unset, and the probe arguments pass the tools' validator."""
        return dict(k=int(request.k or 10), metric=request.metric or None,
                    where=(json.loads(request.filter_json)
                           if request.filter_json else None),
                    **tools_mod.probe_kwargs(
                        {"nprobe": request.nprobe or None,
                         "recall_target": request.recall_target or None}))

    def _hits_to_reply(self, hits, seq=0):
        pb = self.pb
        return pb.SearchReply(seq=seq, hits=[
            pb.Hit(id=str(i), distance=float(d),
                   metadata_json=json.dumps(m) if m else "")
            for (i, m, d) in hits
        ])

    def Search(self, request, context):
        self._auth(context, "Search")
        try:
            metrics.inc("grpc.searches")
            hits = self.db.batcher.search(
                request.store, np.asarray(request.vector, np.float32),
                **self._search_kw(request))
            return self._hits_to_reply(hits, request.seq)
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)

    def SearchBatch(self, request, context):
        self._auth(context, "SearchBatch")
        call = self._call
        a = getattr(call, "arrival", None)
        try:
            t_rows = now_ns()
            rows = _decode_rows(request.vectors_f32, request.dim)
            count = rows.shape[0]
            if a is not None:
                call.n = count
                metrics.record("grpc.decode", a.rid, 0, a.t0, a.t_parsed,
                               count)
                metrics.record("grpc.decode", a.rid, 0, t_rows, now_ns(),
                               count)
            dists, _rows, ids = self.db.batcher.search_group(
                request.store, rows, raw=True, **self._search_kw(request))
            if a is not None:
                call.t_encode = now_ns()
            kk = dists.shape[1] if dists.size else 0
            flat_ids = ([""] * (count * kk) if ids is None else
                        ["" if v is None else str(v)
                         for v in ids.reshape(-1).tolist()])
            metrics.inc("grpc.searches", count)
            return self.pb.SearchBatchReply(
                count=count, k=kk, ids=flat_ids,
                distances_f32=np.ascontiguousarray(
                    dists, dtype="<f4").tobytes())
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)

    def StreamSearch(self, request_iterator, context):
        self._auth(context, "StreamSearch")
        out: "queue.Queue" = queue.Queue()
        SENTINEL = object()
        submitted = [0]

        def pump():
            try:
                for req in request_iterator:
                    def cb(hits, err, seq=req.seq):
                        out.put((seq, hits, err))

                    try:
                        self.db.batcher.submit(
                            req.store, np.asarray(req.vector, np.float32),
                            callback=cb, **self._search_kw(req))
                    except Exception as e:  # noqa: BLE001
                        cb(None, e)
                    submitted[0] += 1
            finally:
                out.put(SENTINEL)

        threading.Thread(target=pump, daemon=True,
                         name="evdb-grpc-stream-pump").start()
        delivered = 0
        draining = False
        while True:
            item = out.get()
            if item is SENTINEL:
                draining = True
                if delivered >= submitted[0]:
                    return
                continue
            seq, hits, err = item
            if err is not None:
                yield self.pb.SearchReply(seq=seq, error=str(err))
            else:
                yield self._hits_to_reply(hits, seq)
            delivered += 1
            metrics.inc("grpc.searches")
            if draining and delivered >= submitted[0]:
                return

    # -------------------------------------------------------------- admin

    def Backup(self, request, context):
        self._auth(context, "Backup")
        try:
            path = self.db.backup_store(request.store,
                                        request.backup_name or "grpc")
            return self.pb.BackupReply(path=str(path))
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)

    def Restore(self, request, context):
        self._auth(context, "Restore")
        try:
            info = self.db.restore_store(request.backup_file,
                                         request.new_name or None)
            return self.pb.StatusReply(ok=True, message=json.dumps(info))
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)

    def ListBackups(self, request, context):
        self._auth(context, "ListBackups")
        try:
            return self.pb.ListBackupsReply(
                backups_json=json.dumps(self.db.list_backups()))
        except Exception as e:  # noqa: BLE001
            self._abort(context, e)
