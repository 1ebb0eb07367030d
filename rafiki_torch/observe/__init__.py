"""Observability of the port, as the reference's ``observe`` package:

- ``metrics``: the process registry of counters, gauges and histograms,
  exposed on every service's ``GET /metrics``;
- ``trace``: trace ids minted at the HTTP edges, carried in bus
  envelopes, spans in a segmented store with sidecar indexes, tail
  sampling, stitched by the admin's ``GET /trace/<id>``;
- ``phases``: trial-lifecycle phase timings and the cache counters
  (``GET /trial_phases``);
- ``attribution``: the serving ledger by bin and tenant;
- ``ServingStats``: the serving front's counters;
- ``profiling``: per-trial ``torch.profiler`` traces, on-demand device
  profiles of a serving worker, the card's peak and the MFU meter.

The token serving family of the generative plane is ``observe.lm``.

``profiling``'s names load with their first use, so what imports only
the registry or the spans (the bus, a broker process) does not import
torch.
"""

import importlib

from . import attribution, metrics, phases, trace
from .serving import ServingStats

_PROFILING = ("H100_PEAK_BF16_FLOPS", "DeviceProfileSession", "MfuMeter",
              "device_peak_flops", "flops_of_step", "start_device_profile",
              "trace_session", "trial_trace_dir")

__all__ = ["attribution", "metrics", "phases", "trace", "ServingStats",
           *_PROFILING]


def __getattr__(name):
    if name in _PROFILING:
        return getattr(importlib.import_module(".profiling", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
