"""Navigation: ground-plane estimation, the traversability grid,
free-space analysis and obstacle tracking (ports of
``trackiellm_tpu/navigation/``; the obstacle tracker is a copy)."""

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
from trackiellm_tpu_torch.navigation.obstacle_tracker import (  # noqa: F401
    ObstacleTracker,
    TrackedObstacle,
)
