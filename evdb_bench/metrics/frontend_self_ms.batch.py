"""Mean milliseconds a gRPC SearchBatch request spends in the frontend
itself: the harness span around the handler, minus the store search it
submitted (submit to completion, the store span of the same ticket)."""

from evdb_bench.readers import mean_ms


def read(ctx):
    spans = ctx["spans"]
    if spans is None:
        return None
    vals = []
    for s, e, tickets in spans.within("frontend.grpc", ctx["t0"], ctx["t1"]):
        inner = sum(t.evdb_bench_end - t.t0 for t in tickets or ()
                    if hasattr(t, "evdb_bench_end"))
        vals.append(e - s - inner)
    return mean_ms(vals)
