"""AdvisorWorker: one search shared by many train workers, over the bus.

The port's copy of ``rafiki_tpu/advisor/worker.py``. The
``AdvisorWorker`` owns the advisor of one sub-train-job and serves an
RPC loop on the bus; ``RemoteAdvisor`` is the train worker's proxy with
the in-process advisor's ``propose``/``feedback``/``forget``/``best``,
so ``TrialRunner`` cannot tell the difference. A request sent from a
traced thread carries the trace envelope (``observe.trace``), and the
advisor records its work on it as an ``advisor.<op>`` span.

Queues: requests on ``adv:{sub_id}:req``; replies on a per-request queue
``adv:{sub_id}:rep:{req_id}``.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, Optional, Tuple

from ..bus import BaseBus
from ..model.knobs import Knobs
from ..observe import trace
from .base import BaseAdvisor, Proposal


def _req_queue(sub_id: str) -> str:
    return f"adv:{sub_id}:req"


def _rep_queue(sub_id: str, req_id: str) -> str:
    return f"adv:{sub_id}:rep:{req_id}"


class AdvisorWorker:
    """Serves one advisor's RPC loop on a daemon thread (``start``)."""

    def __init__(self, advisor: BaseAdvisor, bus: BaseBus,
                 sub_train_job_id: str):
        self.advisor = advisor
        self.bus = bus
        self.sub_id = sub_train_job_id
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "AdvisorWorker":
        self._thread = threading.Thread(
            target=self.run, name=f"advisor-{self.sub_id[:8]}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def run(self) -> None:
        while not self._stop.is_set():
            req = self.bus.pop(_req_queue(self.sub_id), timeout=0.25)
            if req is None:
                continue
            try:
                self._handle(req)
            except Exception as e:
                req_id = req.get("req_id")
                if req_id:
                    self.bus.push(_rep_queue(self.sub_id, req_id),
                                  {"error": f"{type(e).__name__}: {e}"})

    def _handle(self, req: Dict[str, Any]) -> None:
        """Take the trace envelope off (a frame without one is served
        the same) and time the advisor's work as a span under it."""
        ctxs = trace.extract(req)
        if not ctxs:
            self._dispatch(req)
            return
        wall = time.time()
        t0 = time.monotonic()
        try:
            self._dispatch(req)
        finally:
            trace.record_event(
                f"advisor.{req.get('op')}", f"advisor-{self.sub_id[:8]}",
                ctxs, wall, time.monotonic() - t0)

    def _dispatch(self, req: Dict[str, Any]) -> None:
        op, req_id = req.get("op"), req.get("req_id")
        if op == "propose":
            proposal = self.advisor.propose()
            self.bus.push(_rep_queue(self.sub_id, req_id), {
                "proposal": None if proposal is None else proposal.to_json()})
        elif op == "feedback":
            self.advisor.feedback(Proposal.from_json(req["proposal"]),
                                  float(req["score"]))
        elif op == "forget":
            self.advisor.forget(Proposal.from_json(req["proposal"]))
        elif op == "best":
            best = self.advisor.best()
            self.bus.push(_rep_queue(self.sub_id, req_id), {
                "best": None if best is None else
                {"knobs": best[0], "score": best[1]}})
        else:
            raise ValueError(f"unknown advisor op: {op!r}")


class RemoteAdvisor:
    """Train-worker-side proxy with the in-process advisor surface."""

    def __init__(self, bus: BaseBus, sub_train_job_id: str,
                 timeout: float = 60.0):
        self.bus = bus
        self.sub_id = sub_train_job_id
        self.timeout = timeout

    @staticmethod
    def _inject_trace(req: Dict[str, Any]) -> Dict[str, Any]:
        """Carry the calling thread's trace context, if any, in the
        request frame (the serving scatter's envelope)."""
        env = trace.inject([trace.current()])
        if env is not None:
            req[trace.ENVELOPE_KEY] = env
        return req

    def _rpc(self, req: Dict[str, Any]) -> Dict[str, Any]:
        req_id = uuid.uuid4().hex
        req["req_id"] = req_id
        self.bus.push(_req_queue(self.sub_id), self._inject_trace(req))
        rep = self.bus.pop(_rep_queue(self.sub_id, req_id),
                           timeout=self.timeout)
        if rep is None:
            # Reap the one-shot reply queue: a late reply must not leak.
            self.bus.delete_queue(_rep_queue(self.sub_id, req_id))
            raise TimeoutError(
                f"advisor for {self.sub_id} did not reply in {self.timeout}s")
        if "error" in rep:
            raise RuntimeError(f"advisor error: {rep['error']}")
        return rep

    def propose(self) -> Optional[Proposal]:
        d = self._rpc({"op": "propose"})["proposal"]
        return None if d is None else Proposal.from_json(d)

    def feedback(self, proposal: Proposal, score: float) -> None:
        self.bus.push(_req_queue(self.sub_id), self._inject_trace({
            "op": "feedback", "proposal": proposal.to_json(),
            "score": float(score)}))

    def forget(self, proposal: Proposal) -> None:
        self.bus.push(_req_queue(self.sub_id), self._inject_trace({
            "op": "forget", "proposal": proposal.to_json()}))

    def best(self) -> Optional[Tuple[Knobs, float]]:
        d = self._rpc({"op": "best"})["best"]
        return None if d is None else (d["knobs"], d["score"])
