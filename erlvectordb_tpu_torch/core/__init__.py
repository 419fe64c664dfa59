from erlvectordb_tpu_torch.core.store import (  # noqa: F401
    VectorStore,
    DimensionMismatch,
    InvalidVector,
)
from erlvectordb_tpu_torch.core.registry import (  # noqa: F401
    StoreRegistry,
    StoreExists,
    StoreNotFound,
)
from erlvectordb_tpu_torch.core import search  # noqa: F401
