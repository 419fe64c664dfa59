from erlvectordb_tpu_torch.utils import vector_math  # noqa: F401
