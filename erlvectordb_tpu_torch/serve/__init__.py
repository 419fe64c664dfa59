from erlvectordb_tpu_torch.serve.oauth import OAuthError, OAuthServer  # noqa: F401
from erlvectordb_tpu_torch.serve import tools  # noqa: F401
