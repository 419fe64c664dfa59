"""Quantizers of the port: product quantization and its rotated form.

The JAX package's ``quant/compression.py`` (with ``affine``, ``codecs`` and
``pca``) is not ported yet."""

from erlvectordb_tpu_torch.quant.pq import PQCodebook  # noqa: F401
from erlvectordb_tpu_torch.quant.opq import OPQCodebook  # noqa: F401
