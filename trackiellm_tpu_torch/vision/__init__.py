"""Vision: the per-frame pipeline, box-depth fusion, attributes and the
scene graph (ports of ``trackiellm_tpu/vision/``; QR detection waits for
the app loop)."""

from trackiellm_tpu_torch.vision.pipeline import (  # noqa: F401
    AnalysisFlags,
    DetectedObject,
    TextRegion,
    VisionConfig,
    VisionPipeline,
    VisionResult,
)
