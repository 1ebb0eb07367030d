"""Observability of the port: the train loop's MFU meter, the metrics
registry (``metrics``), request tracing (``trace``) and the serving
frontend's counters (``ServingStats``)."""

from . import metrics, trace
from .profiling import H100_PEAK_BF16_FLOPS, MfuMeter
from .serving import ServingStats

__all__ = ["H100_PEAK_BF16_FLOPS", "MfuMeter", "ServingStats", "metrics",
           "trace"]
