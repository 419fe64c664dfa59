"""erlvectordb_tpu_torch — the vector database on PyTorch and CUDA.

The port of ``erlvectordb_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100: device-resident f32/int8 stores whose search runs hand-written
Hopper kernels (``csrc/``), served over the MCP JSON-RPC protocol.  It
imports ``torch`` and never ``jax``; module names mirror the JAX package's.
"""

__version__ = "0.1.0"

from erlvectordb_tpu_torch.core import (  # noqa: F401
    DimensionMismatch,
    InvalidVector,
    StoreExists,
    StoreNotFound,
    StoreRegistry,
    VectorStore,
)


def __getattr__(name):
    # lazy: Database/Application pull in the serving modules
    if name == "Database":
        from erlvectordb_tpu_torch.api import Database

        return Database
    if name == "Application":
        from erlvectordb_tpu_torch.app import Application

        return Application
    raise AttributeError(name)
