"""Observability of the port: so far the train loop's MFU meter."""

from .profiling import H100_PEAK_BF16_FLOPS, MfuMeter

__all__ = ["H100_PEAK_BF16_FLOPS", "MfuMeter"]
