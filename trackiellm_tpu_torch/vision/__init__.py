"""Vision: the per-frame pipeline, box-depth fusion, attributes, the
scene graph and QR detection (ports of ``trackiellm_tpu/vision/``;
``qr.py`` and ``qr_decode.py`` are copies)."""

from trackiellm_tpu_torch.vision.pipeline import (  # noqa: F401
    AnalysisFlags,
    DetectedObject,
    TextRegion,
    VisionConfig,
    VisionPipeline,
    VisionResult,
)
