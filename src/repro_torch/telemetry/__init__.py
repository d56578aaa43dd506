"""Self-telemetry in the paper's CUPTI trace format + the straggler
monitor that closes the loop (the recorder, and the monitor whose fences
run on the ``iqr`` kernel)."""

from .recorder import (KIND_CKPT, KIND_DATA, KIND_DECODE, KIND_PREFILL,
                       KIND_TRAIN, StepEvent, TelemetryRecorder, gpu_info)
from .straggler import (ACTION_CHECKPOINT, ACTION_NONE, ACTION_REBALANCE,
                        ACTION_WARN, MonitorConfig, StragglerMonitor,
                        StragglerReport)

__all__ = ["ACTION_CHECKPOINT", "ACTION_NONE", "ACTION_REBALANCE",
           "ACTION_WARN", "KIND_CKPT", "KIND_DATA", "KIND_DECODE",
           "KIND_PREFILL", "KIND_TRAIN", "MonitorConfig", "StepEvent",
           "StragglerMonitor", "StragglerReport", "TelemetryRecorder",
           "gpu_info"]
