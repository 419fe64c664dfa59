"""The load generator: schedules, latency from the due time, the wire
encodings, and inputs reproducible from the seed."""

import numpy as np
import pytest
import torch

from evdb_bench import corpus, harness, spec
from evdb_bench.client import Conn, spacings
from evdb_bench.wire import mcp_request, pb_field

BATCH = spec.request_kind("grpc_search_batch")

SEED = 2**31 + 12345          # seeds may pass 32 signed bits


def job(traffic=None, **kw):
    base = {"request": "mcp_search_vectors", "host": "127.0.0.1", "port": 1,
            "target": "s", "k": 10, "dim": 4, "rate_per_conn": 500.0,
            "traffic": traffic or {}, "seed": SEED, "seconds": 20,
            "warmup_requests": 3, "grace_s": 60.0, "n_queries": 50}
    base.update(kw)
    return base


def queries(n=50, d=4):
    return np.arange(n * d, dtype=np.float32).reshape(n, d)


def test_open_loop_schedule_is_poisson_and_seeded():
    a = Conn(job(), 0, queries())
    b = Conn(job(), 0, queries())
    c = Conn(job(seed=SEED + 1), 0, queries())
    other = Conn(job(), 1, queries())
    assert np.array_equal(a.due, b.due) and np.array_equal(a.keys, b.keys)
    assert not np.array_equal(a.due[:50], c.due[:50])
    assert not np.array_equal(a.due[:50], other.due[:50])
    assert np.all(np.diff(a.due) >= 0) and a.due[-1] < 20
    gaps = np.diff(a.due)
    assert len(a.due) == 500 * 20 == len(c.due)      # the offered count
    assert abs(gaps.std() / gaps.mean() - 1) < 0.1  # exponential gaps


def test_every_seed_offers_the_same_gaps_and_the_same_last_request():
    runs = [Conn(job(seed=SEED + i), ci, queries())
            for i in range(3) for ci in range(2)]
    gaps = [np.diff(np.concatenate([[0.0], c.due, [20.0]])) for c in runs]
    fixed = spacings(500 * 20, 20)
    for g in gaps:
        assert np.allclose(np.sort(g), fixed)       # the same set of gaps
        assert g[-1] == pytest.approx(fixed.max())  # the longest one last
    for c in runs:                                  # due at the same time
        assert c.due[-1] == pytest.approx(20 - fixed[-1], abs=1e-9)
    assert not np.array_equal(gaps[0][:50], gaps[2][:50])   # in other orders
    assert fixed.sum() == pytest.approx(20) and np.all(np.diff(fixed) > 0)


def test_batch_requests_take_the_fixed_batches_in_turn():
    c = Conn(job({"batch": 8, "distinct_requests": 3},
                 request="grpc_search_batch", rate_per_conn=5.0), 2,
             queries())
    assert len(c.due) == 100 and len(c.keys) == 103
    assert set(np.unique(c.keys)) == {0, 1, 2} == set(c.payloads)
    assert np.all(np.diff(c.keys[:9]) % 3 == 1)


def test_latency_runs_from_the_due_time():
    """A stall charges every request behind it; a failure misses any limit."""
    due = np.arange(100) * 0.01
    recv = due + 0.002
    recv[10:20] = 0.25                 # the server stalls until 0.25 s
    recs = np.stack([np.zeros(100), np.zeros(100), due, due, recv,
                     np.ones(100)], axis=1)
    qps, p50, p99, late = harness.end_to_end(recs, 1.0, 1)
    assert qps == 100.0
    assert p99 == pytest.approx(np.percentile(recv - due, 99) * 1e3)
    assert p99 > 100.0 and p50 == pytest.approx(2.0)
    recs[5, 5] = 0.0                   # an error reply
    recs[6, 5], recs[6, 4] = -1.0, np.nan   # never answered
    qps2, _p50, p99_2, _ = harness.end_to_end(recs, 1.0, 1)
    assert qps2 == 98.0 and p99_2 > 60_000


def test_latency_by_part_of_the_window():
    """The diagnostic p50 of each quarter: a stall in the third quarter
    shows there alone."""
    due = np.arange(400) * 0.01
    recv = due + 0.002
    recv[200:300] = due[200:300] + 0.050
    recs = np.stack([np.zeros(400), np.zeros(400), due, due, recv,
                     np.ones(400)], axis=1)
    parts = harness.p50_by_part(recs, 4.0, 4)
    assert parts == pytest.approx([2.0, 2.0, 50.0, 2.0])
    assert harness.end_to_end(recs, 4.0, 1)[1] == pytest.approx(2.0)


def test_answers_inside_the_window_only_count_toward_qps():
    recs = np.array([[0, 0, 0.1, 0.1, 0.9, 1], [0, 0, 0.9, 0.9, 1.2, 1]])
    assert harness.end_to_end(recs, 1.0, 1024)[0] == 1024.0


def test_search_batch_wire_round_trip():
    q = queries(8)
    req = BATCH.encode({"batch": 8}, "glove", 10, q, 0)
    # a SearchBatchReply as the server encodes it
    ids = [str(i) for i in range(8 * 10)]
    d = np.linspace(0, 1, 80, dtype=np.float32)
    reply = (pb_field(1, 0, 8) + pb_field(2, 0, 10)
             + b"".join(pb_field(3, 2, s.encode()) for s in ids)
             + pb_field(4, 2, d.tobytes()))
    count, k, got_ids, got_d = BATCH.parse_reply(reply)
    assert (count, k, got_ids) == (8, 10, ids)
    assert np.array_equal(got_d, d)
    assert q.tobytes() in req and b"glove" in req


def test_answers_are_split_per_query_and_deduplicated():
    rows = BATCH.batch_rows(1, 4, 6)
    assert list(rows) == [4, 5, 0, 1]
    ids = [str(10 + i) for i in range(8)]
    d = np.arange(8, dtype=np.float32)
    body = (pb_field(1, 0, 4) + pb_field(2, 0, 2)
            + b"".join(pb_field(3, 2, s.encode()) for s in ids)
            + pb_field(4, 2, d.tobytes()))
    ans = harness.answers_of(BATCH, {"batch": 4}, [[1, len(body), 3]] * 2,
                             [body, body], 6)
    assert [a[0] for a in ans] == [4, 5, 0, 1]
    assert list(ans[1][1]) == [12, 13]
    text = b'{"results": [{"id": "7", "metadata": {}, "distance": 0.5}]}'
    ans = harness.answers_of(spec.request_kind("mcp_search_vectors"), {},
                             [[3, len(text), 1]], [text], 6)
    assert ans[0][0] == 3 and list(ans[0][1]) == [7]


def test_mcp_requests_are_json_rpc_lines():
    import json
    tail = spec.request_kind("mcp_search_index").encode({}, "idx", 10,
                                                        queries(1), 0)
    req = json.loads(mcp_request(42, tail))
    assert req["id"] == 42 and req["params"]["name"] == "search_index"
    assert req["params"]["arguments"]["vector"] == [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("name", ["glove100_int8", "cohere1m_int8"])
def test_corpus_is_reproducible_from_the_seed(name):
    from evdb_bench.spec import ROOT, load_json
    cfg = load_json(ROOT / f"evdb_bench/configs/{name}.json")
    cfg.update(rows=3000, test_queries=40)
    a = corpus.draw(cfg, SEED, "cpu", corpus.CORPUS)
    b = corpus.draw(cfg, SEED, "cpu", corpus.CORPUS)
    c = corpus.draw(cfg, SEED + 1, "cpu", corpus.CORPUS)
    q = corpus.draw(cfg, SEED, "cpu", corpus.QUERIES)
    assert a.shape == (3000, cfg["dim"]) and q.shape == (40, cfg["dim"])
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[:40], q)
