from erlvectordb_tpu_torch.infra.config import (  # noqa: F401
    Config,
    ConfigError,
    ServiceConfig,
    is_container_mode,
    is_development_mode,
    load_config,
    startup_sequence,
)
from erlvectordb_tpu_torch.infra.ports import (  # noqa: F401
    PortAllocationError,
    PortManager,
    PortRegistry,
    probe_port,
)
from erlvectordb_tpu_torch.infra.health import HealthCheckServer, HealthHTTPServer  # noqa: F401
from erlvectordb_tpu_torch.infra.signals import SignalHandler  # noqa: F401
from erlvectordb_tpu_torch.infra.startup import StartupCoordinator, StartupError  # noqa: F401
