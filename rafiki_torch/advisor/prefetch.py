"""PrefetchAdvisor: the next proposal computed while a trial trains.

The port's copy of ``rafiki_tpu/advisor/prefetch.py`` (:33-110). A
Gaussian-process refit costs seconds of host time as the history
grows; asked only when a trial starts, it leaves the card idle between
trials. This wrapper computes the NEXT proposal on a background thread
while the current trial trains, so the gap between trials is one hand
off.

The prefetched proposal is computed before the current trial's
feedback arrives, so it is one observation stale: the asynchrony that
N workers sharing one advisor already have, and which every strategy
here tolerates. A buffered ``None`` (the search looked spent) is asked
again live, so a ``forget`` refund that landed since is honoured.
``close()`` (or the context manager) ends the search: the last
prefetched, never handed out proposal is ``forget``-ed, so strategies
with per-proposal state (ENAS's REINFORCE meta, ASHA's pending rungs,
the budget's slots) stay balanced.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

from .base import Proposal

_log = logging.getLogger(__name__)


class PrefetchAdvisor:
    """Wraps any advisor; delegates everything, pipelines ``propose``."""

    def __init__(self, advisor: Any):
        self._advisor = advisor
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="advisor-prefetch")
        self._future: Optional[Future] = None
        self._lock = threading.Lock()
        self._closed = False

    def propose(self) -> Optional[Proposal]:
        with self._lock:
            if self._closed:
                raise RuntimeError("PrefetchAdvisor is closed")
            future, self._future = self._future, None
        # Resolve THIS call's proposal first (inline on the first call,
        # from the prefetch buffer afterwards) so trial numbering stays
        # in propose-call order, THEN kick off the next one — it
        # computes while the caller trains.
        p = self._advisor.propose() if future is None else future.result()
        if p is None and future is not None:
            # A buffered None is STALE: it was computed before any
            # forget() refunds that may have landed since (an errored
            # trial at the budget boundary re-proposes through exactly
            # this path) — ask again live so the refund is honored.
            p = self._advisor.propose()
        with self._lock:
            # No further prefetch once the search reports exhausted:
            # later refunds are served by the live re-ask above.
            if not self._closed and self._future is None and p is not None:
                self._future = self._pool.submit(self._advisor.propose)
        return p

    def feedback(self, proposal: Proposal, score: float) -> None:
        self._advisor.feedback(proposal, score)

    def forget(self, proposal: Proposal) -> None:
        forget = getattr(self._advisor, "forget", None)
        if forget is not None:
            forget(proposal)

    def close(self) -> None:
        """Flush the dangling prefetch (refunding its budget slot).

        A background ``propose`` error is logged and dropped — the
        proposal was never handed out, and close() often runs during
        exception unwind (``__exit__``), where re-raising would mask
        the primary error. The pool shuts down regardless."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            future, self._future = self._future, None
        try:
            if future is not None:
                leftover = future.result()
                if leftover is not None:
                    self.forget(leftover)
        except Exception:
            _log.warning("prefetched proposal failed during close; "
                         "dropping it", exc_info=True)
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "PrefetchAdvisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __getattr__(self, name: str) -> Any:
        # best(), knob_config, etc. — transparent delegation.
        return getattr(self._advisor, name)
