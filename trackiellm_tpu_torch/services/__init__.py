"""Services & ops: monitoring, profiling, security, networking,
deployment, plugins, experiments. Replacement for the reference's Rust
service crates (src/{monitoring,profiling,security,networking,
deployment,integration,experiments})."""

from trackiellm_tpu_torch.services.monitoring import (  # noqa: F401
    MetricsCollector,
    MonitoringService,
    TelemetrySender,
)
from trackiellm_tpu_torch.services.profiling import Profiler, profile_scope  # noqa: F401
from trackiellm_tpu_torch.services.security import AuthManager, KeyManager  # noqa: F401
from trackiellm_tpu_torch.services.networking import (  # noqa: F401
    ConnectionPool,
    FrameDecoder,
    encode_frame,
)
from trackiellm_tpu_torch.services.deployment import (  # noqa: F401
    DeploymentService,
    PackageManager,
    VersionChecker,
)
from trackiellm_tpu_torch.services.integration import PluginManager  # noqa: F401
from trackiellm_tpu_torch.services.experiments import (  # noqa: F401
    ExperimentService,
    MetricsComparator,
)
