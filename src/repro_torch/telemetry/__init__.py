"""Self-telemetry in the paper's CUPTI trace format (the recorder; the
straggler monitor comes with the training slice)."""

from .recorder import (KIND_CKPT, KIND_DATA, KIND_DECODE, KIND_PREFILL,
                       KIND_TRAIN, StepEvent, TelemetryRecorder, gpu_info)

__all__ = ["KIND_CKPT", "KIND_DATA", "KIND_DECODE", "KIND_PREFILL",
           "KIND_TRAIN", "StepEvent", "TelemetryRecorder", "gpu_info"]
