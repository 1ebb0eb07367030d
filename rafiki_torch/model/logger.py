"""In-training structured logging for models.

The port's copy of ``rafiki_tpu/model/logger.py``: ``logger.log(...)``
and ``logger.define_plot(...)`` emit structured records to a sink that
whoever runs the model swaps in (a train worker, a test). Models never
talk to storage directly.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

LogRecord = Dict[str, Any]
LogSink = Callable[[LogRecord], None]


class ModelLogger:
    """The sink binding is thread-local: threads that share this
    module-level logger each route their model's records to their own
    sink."""

    def __init__(self):
        self._tls = threading.local()

    def set_sink(self, sink: Optional[LogSink]) -> None:
        self._tls.sink = sink

    def current_sink(self) -> Optional[LogSink]:
        """This thread's sink binding. A harness that installs a
        temporary sink saves this and restores it on exit."""
        return getattr(self._tls, "sink", None)

    def _emit(self, record: LogRecord) -> None:
        record.setdefault("time", time.time())
        sink = getattr(self._tls, "sink", None)
        if sink is not None:
            sink(record)

    def log(self, **metrics: Any) -> None:
        """Log named metric values at the current instant."""
        self._emit({"type": "values",
                    "values": {k: _to_py(v) for k, v in metrics.items()}})

    def define_plot(self, title: str, metrics: List[str],
                    x_axis: str) -> None:
        """Declare a chart: which logged metrics to plot against which axis."""
        self._emit({"type": "plot", "plot": {
            "title": title, "metrics": list(metrics), "x_axis": x_axis}})

    def define_loss_plot(self) -> None:
        """The loss-by-epoch chart, for a model that logs ``loss`` each
        epoch."""
        self.define_plot("Loss over epochs", ["loss"], x_axis="epoch")


def _to_py(v: Any) -> Any:
    # numpy / torch scalars → python scalars so records stay JSON-serialisable
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    return v


logger = ModelLogger()
