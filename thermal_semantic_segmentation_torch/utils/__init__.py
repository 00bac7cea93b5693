"""Meters, logging, observability."""

from .logging import get_logger
from .meters import AverageMeter, ProgressMeter
from .observability import (MetricsLogger, VisdomPlotter, enable_debug_mode,
                            profiler_trace, step_annotation)

__all__ = ["get_logger", "AverageMeter", "ProgressMeter", "MetricsLogger",
           "VisdomPlotter", "enable_debug_mode", "profiler_trace",
           "step_annotation"]
