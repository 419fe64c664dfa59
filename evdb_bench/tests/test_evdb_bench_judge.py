"""The reference, the comparison, the roofline counts and the readers."""

import numpy as np
import pytest
import torch

from evdb_bench import judge, roofline, spec
from evdb_bench.control import control_numbers
from evdb_bench.reference.exact import Exact, quantize
from evdb_bench.spans import Spans


def data(n=2000, d=100, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, d), generator=g)


def test_quantize_is_symmetric_absmax():
    x = torch.tensor([[1.0, -0.5, 0.25], [0.0, 0.0, 0.0]])
    codes, scale = quantize(x, 8)
    assert torch.equal(codes[0], torch.tensor([127.0, -63.0, 32.0])) or \
        torch.equal(codes[0], torch.tensor([127.0, -64.0, 32.0]))
    assert scale[1] == 1.0 and torch.all(codes[1] == 0)
    assert quantize(x, 4)[0].abs().max() == 7


def test_reference_topk_is_the_brute_force_ranking():
    x, q = data(), data(16, seed=1)
    d, ids = Exact(x, None).topk(q, 10)
    cos = (q.double() @ x.double().T) / (q.double().norm(dim=1)[:, None]
                                         * x.double().norm(dim=1))
    want = torch.topk(1 - cos, 10, largest=False)
    assert torch.equal(ids, want.indices)
    assert torch.allclose(d, want.values, atol=1e-12)
    assert torch.allclose(Exact(x, None).dist_of(q, ids), d, atol=1e-12)
    # int8: the reference's own distances of its own answers agree
    d8, i8 = Exact(x, 8).topk(q, 10)
    assert torch.allclose(Exact(x, 8).dist_of(q, i8), d8, atol=1e-6)


def _answers(dist, ids):
    return [(i, ids[i].numpy(), dist[i].numpy()) for i in range(ids.shape[0])]


def test_exact_answers_pass_and_altered_ones_fail():
    x, q = data(), data(32, seed=1)
    d, ids = Exact(x, 8).topk(q, 10)
    good = judge.numbers("store", _answers(d, ids), q, x, 10, bits=8)
    assert good["dist_err"] < 1e-6 and good["topk_gap"] == 0
    limits = {"dist_err": {"max": 1e-4}, "topk_gap": {"max": 1e-3}}
    assert judge.verdict({**good, "missing": 0}, limits)[0]
    ids2 = ids.clone()
    ids2[3, 0] = ids[3, -1] + 1 if ids[3, -1] + 1 < 2000 else 0
    bad = judge.numbers("store", _answers(d, ids2), q, x, 10, bits=8)
    assert bad["malformed"] > 0 or bad["dist_err"] > 1e-4
    ids3 = ids.clone()
    ids3[:, 9] = torch.topk(Exact(x, 8).topk(q, 50)[1], 1, dim=1).values[:, 0]
    d3 = Exact(x, 8).dist_of(q, ids3)
    d3, order = torch.sort(d3, dim=1)
    ids3 = torch.gather(ids3, 1, order)
    gap = judge.numbers("store", _answers(d3, ids3), q, x, 10, bits=8)
    assert gap["topk_gap"] > 1e-3
    assert not judge.verdict({**gap, "missing": 0}, limits)[0]
    assert not judge.verdict({**good, "missing": 1}, limits)[0]


def test_malformed_answers_are_counted():
    x, q = data(), data(4, seed=1)
    d, ids = Exact(x, 8).topk(q, 10)
    ans = _answers(d, ids)
    ans[0] = (0, ans[0][1][:9], ans[0][2][:9])             # short
    ans[1] = (1, np.r_[ans[1][1][:9], ans[1][1][0]], ans[1][2])  # repeated
    ans[2] = (2, ans[2][1], ans[2][2][::-1].copy())        # out of order
    assert judge.numbers("store", ans, q, x, 10, bits=8)["malformed"] == 3


@pytest.mark.parametrize("name,kind", [("glove100_int8", "store"),
                                       ("cohere1m_int8", "store"),
                                       ("cohere1m_int8", "index")])
def test_the_control_fails_on_the_cpu(name, kind):
    """The reference one precision below (int4) fails the configuration's
    limits at a size the CPU holds; the card's readings at the cells' own
    sizes are test_evdb_bench_control.py's."""
    cfg = spec.load_json(spec.ROOT / f"evdb_bench/configs/{name}.json")
    cfg.update(rows=20000, test_queries=64)
    values = control_numbers(cfg, kind, 7, "cpu")
    assert not judge.verdict(values, cfg["correct"][kind])[0]


def test_roofline_counts_for_a_known_shape():
    ops = roofline.int8_scan_ops(1183514, 100, 1024)
    assert ops == 2 * 1183514 * 100 * 1024
    by = roofline.int8_scan_bytes(1183514, 100, 1024, 10, 0)
    assert by == 1183514 * 100 + 1024 * 100 + 1024 * 10 * 8
    assert roofline.int8_scan_bound_s(1183514, 100, 1024, 10, 0) == \
        pytest.approx(ops / 1979e12)
    # one query: the bytes bound the scan
    assert roofline.int8_scan_bound_s(1000000, 768, 1, 10, 8) == \
        pytest.approx((1000000 * 776 + 768 + 80) / 3.35e12)


class FakeTicket:
    def __init__(self, t0, end, nq):
        self.t0, self.evdb_bench_end, self.nq = t0, end, nq


def ctx_with(events, spans):
    from evdb_bench.devtrace import gaps, union
    busy = union([(s, e) for _n, s, e in events], 0.0, 1.0)
    return {"t0": 0.0, "t1": 1.0, "spans": spans, "hist":
            {"batcher.batch_size": (4, 22.0)}, "counters": {},
            "device_events": events, "busy": busy, "idle": gaps(busy, 0, 1),
            "busy_s": sum(e - s for s, e in busy), "window_s": 1.0,
            "config": {"rows": 1183514, "dim": 100, "k": 10}}


def test_readers_on_a_known_trace():
    sp = Spans()
    t = FakeTicket(0.10, 0.13, 1024)
    sp.spans["frontend.grpc"].append((0.09, 0.15, [t]))
    sp.spans["store"].append((0.10, 0.13, 1024))
    kernel = "void (anonymous namespace)::slice_scan_kernel<false, 0, false, false>(x)"
    bound = roofline.int8_scan_bound_s(1183514, 100, 1024, 10, 0)
    events = [(kernel, 0.11, 0.11 + 4 * bound), ("memcpy", 0.5, 0.6)]
    ctx = ctx_with(events, sp)
    read = lambda m: spec.reader(m)(ctx)  # noqa: E731
    assert read("intkey_scan_roofline") == pytest.approx(25.0)
    assert read("pos_scan_i8_roofline") is None
    assert read("frontend_self_ms.batch") == pytest.approx(30.0)
    assert read("store_ms.batch") == pytest.approx(30.0)
    assert read("batch_fill.single") == pytest.approx(5.5)
    assert read("device_idle_pct.batch") == pytest.approx(
        100 * (1 - 4 * bound - 0.1))
    assert read("index_search_ms.single") is None
    ctx["device_events"] = None
    assert read("device_idle_pct.single") is None


@pytest.mark.parametrize("name,key", [("index_kpp_s", "kpp_s"),
                                      ("index_lloyd_s", "lloyd_s"),
                                      ("index_assign_s", "assign_s")])
def test_index_build_readers_read_the_build_stats(name, key):
    """Each reads its phase of the build's stats, and nothing without
    them."""
    read = spec.reader(name)
    ctx = ctx_with([], Spans())
    assert read(ctx) is None
    ctx["prepare_stats"] = None
    assert read(ctx) is None
    ctx["prepare_stats"] = {"cells": 10417}
    assert read(ctx) is None
    stats = {"kpp_s": 2.2762, "lloyd_s": 1.9613, "assign_s": 0.7967,
             "cells": 10417}
    ctx["prepare_stats"] = stats
    assert read(ctx) == stats[key]
