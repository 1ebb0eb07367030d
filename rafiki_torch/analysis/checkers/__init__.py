"""Checker modules; importing this package registers them all."""

from . import (  # noqa: F401
    aliasing,
    concurrency,
    drift,
    flow,
    guarded_state,
    import_hygiene,
    series_lifecycle,
    thread_lifecycle,
)
