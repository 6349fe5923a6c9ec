"""Telemetry: server/client performance monitors + device profiling."""

from facerecognitionpipeline_tpu_torch.telemetry.monitor import (  # noqa: F401
    PerformanceMonitorClient,
    PerformanceMonitorServer,
    PerformanceMonitor,
)
