"""Quantizers and compression of the port: product quantization and its
rotated form, and the six-algorithm compression API (affine 8/4-bit, PCA,
zlib, lz4, product)."""

from erlvectordb_tpu_torch.quant.compression import (  # noqa: F401
    CompressedVector,
    SUPPORTED_ALGORITHMS,
    benchmark_compression,
    compress_batch,
    compress_vector,
    decompress_batch,
    decompress_vector,
    get_compression_ratio,
    get_supported_algorithms,
)
from erlvectordb_tpu_torch.quant.pca import PCAModel  # noqa: F401
from erlvectordb_tpu_torch.quant.pq import PQCodebook  # noqa: F401
from erlvectordb_tpu_torch.quant.opq import OPQCodebook  # noqa: F401
from erlvectordb_tpu_torch.quant import affine, codecs  # noqa: F401
