"""Token serving signals of the generative (LM) plane.

The port's copy of ``rafiki_tpu/observe/lm.py``. The continuous-batching
decode loop (``worker/decode_scheduler.py``) is judged in tokens:

- ``rafiki_tpu_lm_time_to_first_token_seconds``: admission to first
  frame, a request (histogram);
- ``rafiki_tpu_lm_inter_token_seconds``: one decode step's wall time
  (one observation a step: the step is the batched unit of work);
- ``rafiki_tpu_lm_tokens_total``: generated tokens;
- ``rafiki_tpu_lm_decode_dispatches_total``: decode-step launches;
  tokens over dispatches is the batching factor;
- ``rafiki_tpu_lm_prefill_total{mode=run|cached}``: prefills run and
  skipped whole by the prefix cache;
- ``rafiki_tpu_lm_preemptions_total``: sequences evicted under page-pool
  pressure;
- ``rafiki_tpu_lm_kv_pool_used_ratio`` and
  ``rafiki_tpu_lm_resident_tokens``: the KV page pool's occupancy.

The family exists only while ``RAFIKI_TPU_SERVING_GENERATE`` is on and
metrics are enabled, read once a process at first use (``reset_for_tests``
reads them again): a process that does not generate pays one check a
call and exposes no ``rafiki_tpu_lm_*`` series.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

from . import metrics as _metrics

GENERATE_ENV = "RAFIKI_TPU_SERVING_GENERATE"

#: Inter-token cadence lives in single-digit milliseconds on a real
#: chip; TTFT in tens-to-hundreds (prefill + queue). One bucket ladder
#: covers both with resolution where each actually lands.
_TOKEN_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                  0.25, 0.5, 1.0, 2.5, 5.0)


def generate_enabled(raw: Optional[str] = None) -> bool:
    """Whether generative serving is requested — the ONE resolution of
    ``RAFIKI_TPU_SERVING_GENERATE`` (same falsy spellings as every
    NodeConfig bool; absent = off, matching apply_env's pop)."""
    if raw is None:
        raw = os.environ.get(GENERATE_ENV, "")
    return raw.strip().lower() not in ("", "0", "false", "no", "off")


#: (ttft, inter, tokens, dispatches, prefill, preempt, pool, resident)
#: or the all-None tuple; resolved at first use under the lock, then
#: read lock-free.
_state: Optional[Tuple] = None
_lock = threading.Lock()


def _family() -> Tuple:
    global _state
    # rta: disable=RTA101 double-checked init: the bare read is the fast path; the write re-checks under _lock
    s = _state
    if s is None:
        with _lock:
            s = _state
            if s is None:
                if generate_enabled() and _metrics.metrics_enabled():
                    reg = _metrics.registry()
                    s = (
                        reg.histogram(
                            "rafiki_tpu_lm_time_to_first_token_seconds",
                            "Generate-request admit to first token "
                            "frame (prefill + queueing)",
                            buckets=_TOKEN_BUCKETS),
                        reg.histogram(
                            "rafiki_tpu_lm_inter_token_seconds",
                            "Decode-step wall time (one observation "
                            "per batched step)",
                            buckets=_TOKEN_BUCKETS),
                        reg.counter(
                            "rafiki_tpu_lm_tokens_total",
                            "Tokens generated by the decode loop"),
                        reg.counter(
                            "rafiki_tpu_lm_decode_dispatches_total",
                            "Compiled decode-program launches "
                            "(tokens/dispatches ~= batch width under "
                            "continuous batching)"),
                        reg.counter(
                            "rafiki_tpu_lm_prefill_total",
                            "Prompt prefills (mode=run: executed; "
                            "mode=cached: skipped whole via the "
                            "prefix cache)"),
                        reg.counter(
                            "rafiki_tpu_lm_preemptions_total",
                            "Sequences evicted under KV page-pool "
                            "pressure (re-queued for recompute)"),
                        reg.gauge(
                            "rafiki_tpu_lm_kv_pool_used_ratio",
                            "Fraction of the KV page pool allocated "
                            "(the admission gate's own signal)"),
                        reg.gauge(
                            "rafiki_tpu_lm_resident_tokens",
                            "Tokens currently resident in the paged "
                            "KV cache across all decoding sequences"),
                    )
                else:
                    s = (None,) * 8
                _state = s
    return s


def serving() -> bool:
    """Whether the lm family is live — callers that must COMPUTE a
    timing first check this so a disabled plane pays nothing."""
    return _family()[0] is not None


def observe_ttft(seconds: float) -> None:
    h = _family()[0]
    if h is not None and seconds >= 0:
        h.observe(seconds)


def observe_inter_token(seconds: float) -> None:
    h = _family()[1]
    if h is not None and seconds >= 0:
        h.observe(seconds)


def count_tokens(n: int) -> None:
    c = _family()[2]
    if c is not None and n > 0:
        c.inc(n)


def count_decode_dispatch(n: int = 1) -> None:
    c = _family()[3]
    if c is not None and n > 0:
        c.inc(n)


def count_prefill(cached: bool, n: int = 1) -> None:
    c = _family()[4]
    if c is not None and n > 0:
        # rta: disable=RTA301 mode is the fixed run|cached vocabulary; the family is gated on RAFIKI_TPU_SERVING_GENERATE and deliberately immortal while on
        c.inc(n, mode="cached" if cached else "run")


def count_preemption(n: int = 1) -> None:
    c = _family()[5]
    if c is not None and n > 0:
        c.inc(n)


def set_pool_used(ratio: float) -> None:
    g = _family()[6]
    if g is not None:
        g.set(max(0.0, min(1.0, ratio)))


def set_resident_tokens(n: int) -> None:
    g = _family()[7]
    if g is not None:
        g.set(max(0, n))


def reset_for_tests() -> None:
    """Drop the cached enabled-state so a test that flips
    ``RAFIKI_TPU_SERVING_GENERATE`` / ``RAFIKI_TPU_METRICS`` sees its
    env take effect (production resolves once, by design)."""
    global _state
    with _lock:
        _state = None
