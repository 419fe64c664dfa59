"""The corpora and test queries of a configuration, drawn from ``--seed``.

Two recipes, copied from the program's bench verb
(``erlvectordb_tpu_torch/bench.py``) and drawn here with torch generators on
the run's device in a few large calls:

  * ``clustered``: ``centres`` N(0, 1) centres, each row a centre plus
    ``noise`` N(0, 1) (bench.py's ``make_corpus``);
  * ``manifold``: ``centres`` N(0, 1) centres in a ``latent``-d space, each
    row a centre plus ``noise`` N(0, 1) there, projected to ``dim`` by N(0, 1)
    / sqrt(latent) entries, plus ``noise_d`` isotropic noise (bench.py's
    ``manifold``).

The test queries are further rows of the same distribution, from a stream
of their own, so the same seed gives the same corpus and the same queries.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

CORPUS, QUERIES, PARAMS = 1, 2, 3
CHUNK = 1 << 18


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed per (run seed, stream); any whole seed."""
    return (int(seed) * 16 + stream) % (1 << 63)


@contextmanager
def exact_f32():
    """float32 matrix products without TF32, restored on exit."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def _clustered(params, dim, gp, g, rows, device):
    centres = torch.randn((params["centres"], dim), generator=gp,
                          device=device)
    out = torch.empty((rows, dim), device=device)
    for r0 in range(0, rows, CHUNK):
        n = min(CHUNK, rows - r0)
        pick = torch.randint(0, params["centres"], (n,), generator=g,
                             device=device)
        out[r0:r0 + n] = centres[pick] + params["noise"] * torch.randn(
            (n, dim), generator=g, device=device)
    return out


def _manifold(params, dim, gp, g, rows, device):
    lat = params["latent"]
    centres = torch.randn((params["centres"], lat), generator=gp,
                          device=device)
    proj = torch.randn((lat, dim), generator=gp, device=device) / math.sqrt(lat)
    out = torch.empty((rows, dim), device=device)
    for r0 in range(0, rows, CHUNK):
        n = min(CHUNK, rows - r0)
        pick = torch.randint(0, params["centres"], (n,), generator=g,
                             device=device)
        z = centres[pick] + params["noise"] * torch.randn(
            (n, lat), generator=g, device=device)
        with exact_f32():
            x = z @ proj
        out[r0:r0 + n] = x + params["noise_d"] * torch.randn(
            (n, dim), generator=g, device=device)
    return out


RECIPES = {"clustered": _clustered, "manifold": _manifold}


def draw(config: dict, seed: int, device, stream: int) -> torch.Tensor:
    """The corpus (``stream`` CORPUS, ``config["rows"]`` rows) or the test
    queries (QUERIES, ``config["test_queries"]`` rows) as float32 on
    ``device``.  The recipe's own parameters (centres, projection) come
    from one stream, shared by both."""
    c = config["corpus"]
    rows = config["rows"] if stream == CORPUS else config["test_queries"]
    return RECIPES[c["recipe"]](c, config["dim"], _gen(seed, PARAMS, device),
                                _gen(seed, stream, device), rows, device)
