"""Navigation: ground-plane estimation, the traversability grid and
free-space analysis (ports of ``trackiellm_tpu/navigation/``; the obstacle
tracker waits for the app loop)."""

from trackiellm_tpu_torch.navigation.path_planner import (  # noqa: F401
    CellClass,
    NavigationConfig,
    NavigationEngine,
    ransac_ground_plane,
)
from trackiellm_tpu_torch.navigation.free_space import (  # noqa: F401
    FreeSpaceDetector,
    SpaceSector,
)
