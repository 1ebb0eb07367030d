"""DecodeScheduler: the continuous-batching loop of a generating worker.

The port's copy of ``rafiki_tpu/worker/decode_scheduler.py``. The unit
the loop schedules is the decode step, and admission happens between
steps. Each lap:

1. drain newly arrived requests from the pending queue into the engine
   while the admission gate says yes (a free decode lane AND enough KV
   pages — the gate may spill the prefix cache, never live sequences);
2. run ONE decode step for every resident sequence (one fixed-shape
   program whatever the mix of sequence lengths);
3. stream each produced token to its request's reply queue as a frame
   (``{"seq": k, "tok": [t], "done": ...}``), finishing sequences that
   hit EOS or their budget;
4. re-queue preempted sequences (pool pressure evicted the youngest)
   at the FRONT of the pending queue with their full token trail — the
   restart re-prefills from tokens-so-far and the client just sees a
   pause, never a reset.

Threading contract: ``submit`` is called from any thread; ``loop`` runs
on a dedicated thread. The pending queue is the ONLY shared state and
``_cv`` is its lock — the engine itself is single-threaded by contract
and touched only by the loop thread.

The loop feeds the reference's token family in the metrics registry
(``observe.lm``: TTFT, inter-token time, tokens, decode dispatches,
prefills run and cached, preemptions, pool use; present only while
``RAFIKI_TPU_SERVING_GENERATE`` is on). The scheduler also keeps the
same counters and latency samples of its own, which ``stats()`` reads.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from ..observe import lm as _lm

_log = logging.getLogger(__name__)

#: Latency samples kept per series (the newest).
SAMPLES_CAP = 1 << 16


class DecodeScheduler:
    """Continuous-batching front of one :class:`LMGenerator`.

    ``frames`` carries the token frames (``send_token_frame``);
    ``worker_id`` stamps them.
    """

    def __init__(self, engine: Any, frames: Any, worker_id: str, *,
                 idle_wait: float = 0.02):
        self.engine = engine
        self.frames = frames
        self.worker_id = worker_id
        self.idle_wait = idle_wait
        self.stop_flag = threading.Event()
        # _cv guards _pending: appended by submit, drained by the loop
        # thread. Everything else in here — engine, _live, the
        # counters — is written by the loop thread only; the counters
        # under _stats_lock, so stats() reads one consistent snapshot.
        self._cv = threading.Condition()
        self._pending: "deque[Dict[str, Any]]" = deque()
        # seq_id -> stream state (query_id, next frame index, tokens
        # sent). Survives preemption: the re-admitted sequence keeps
        # its frame numbering.
        self._live: Dict[Any, Dict[str, Any]] = {}
        self.served_total = 0
        self.errors_total = 0
        # The reference's observe.lm series.
        self._stats_lock = threading.Lock()
        self._ttft_s: "deque[float]" = deque(maxlen=SAMPLES_CAP)
        self._inter_token_s: "deque[float]" = deque(maxlen=SAMPLES_CAP)
        self.tokens_total = 0
        self.decode_dispatches_total = 0
        self.prefills_run_total = 0
        self.prefills_cached_total = 0
        self.preemptions_total = 0
        self.pool_used_ratio = 0.0
        self.resident_tokens = 0

    def stats(self) -> Dict[str, Any]:
        """A snapshot of the counters and latency samples (seconds)."""
        with self._stats_lock:
            return {"ttft_s": list(self._ttft_s),
                    "inter_token_s": list(self._inter_token_s),
                    "tokens": self.tokens_total,
                    "decode_dispatches": self.decode_dispatches_total,
                    "prefills_run": self.prefills_run_total,
                    "prefills_cached": self.prefills_cached_total,
                    "preemptions": self.preemptions_total,
                    "pool_used_ratio": self.pool_used_ratio,
                    "resident_tokens": self.resident_tokens,
                    "served": self.served_total,
                    "errors": self.errors_total}

    # --- submitting side ---

    def submit(self, item: Dict[str, Any]) -> None:
        """Accept one ``op="generate"`` frame. Malformed requests are
        answered with an error frame here — the decode loop only ever
        sees well-formed work."""
        gen = item.get("gen") or {}
        qid = item.get("query_id") or ""
        tokens = gen.get("tokens")
        if not qid or not isinstance(tokens, list) or not tokens:
            self._error_frame(qid, "malformed generate request")
            return
        req = {"query_id": qid,
               "tokens": [int(t) for t in tokens],
               "max_new": int(gen.get("max_new") or 16),
               "temperature": float(gen.get("temperature") or 0.0),
               "seed": int(gen.get("seed") or 0),
               "eos": gen.get("eos"),
               "seq_id": None,       # fresh request; resumes carry one
               "n_done": 0,
               "t0": time.monotonic()}
        with self._cv:
            self._pending.append(req)
            self._cv.notify()

    def stop(self) -> None:
        self.stop_flag.set()
        with self._cv:
            self._cv.notify()

    # --- loop thread ---

    def loop(self) -> None:
        """The decode loop; runs until ``stop``. A failed lap is
        counted and logged, and the loop goes on."""
        eng = self.engine
        while not self.stop_flag.is_set():
            try:
                with self._cv:
                    if not self._pending and not eng.resident():
                        self._cv.wait(timeout=self.idle_wait)
                        continue
                self._admit_pending()
                if eng.resident():
                    self._step_once()
            except Exception:
                with self._stats_lock:
                    self.errors_total += 1
                _log.exception("decode scheduler %s: lap failed; "
                               "continuing", self.worker_id)
                time.sleep(0.05)

    def _admit_pending(self) -> None:
        eng = self.engine
        while True:
            with self._cv:
                req = self._pending[0] if self._pending else None
            if req is None:
                return
            remaining = req["max_new"] - req["n_done"]
            if remaining <= 0:
                # A preempted sequence that had already spent its
                # budget: finalize without re-admitting.
                with self._cv:
                    self._pending.popleft()
                self._finish_frame(req["seq_id"], "length")
                continue
            if not eng.can_admit(len(req["tokens"])):
                return  # FIFO: head blocks the queue, not skipped
            with self._cv:
                self._pending.popleft()
            self._admit(req, remaining)

    def _admit(self, req: Dict[str, Any], remaining: int) -> None:
        eng = self.engine
        skipped0 = eng.prefill_skipped_total
        try:
            sid, first = eng.admit(
                req["tokens"], max_new=remaining,
                temperature=req["temperature"], seed=req["seed"],
                eos=req["eos"], seq_id=req["seq_id"])
        except Exception:
            with self._stats_lock:
                self.errors_total += 1
            _log.exception("decode scheduler %s: admit failed",
                           self.worker_id)
            self._error_frame(req["query_id"], "admission failed")
            return
        cached = eng.prefill_skipped_total > skipped0
        _lm.count_prefill(cached=cached)
        with self._stats_lock:
            if cached:
                self.prefills_cached_total += 1
            else:
                self.prefills_run_total += 1
        st = self._live.get(sid)
        if st is None:
            st = {"query_id": req["query_id"], "frame": 0, "n_sent": 0}
            self._live[sid] = st
            ttft = time.monotonic() - req["t0"]
            _lm.observe_ttft(ttft)
            with self._stats_lock:
                self._ttft_s.append(ttft)
        # A resumed sequence keeps its frame numbering — the client's
        # stream just continues. The admit-time token is a frame either
        # way (it IS the first new token of this residency). Budget/EOS
        # met AT admission finishes here — the engine's finish rules
        # only run inside step().
        fin = None
        if req["eos"] is not None and first == int(req["eos"]):
            fin = "eos"
        elif remaining <= 1:
            fin = "length"
        if fin is not None:
            eng.finish(sid)
        self._push_token(sid, first, fin)
        _lm.count_tokens(1)
        with self._stats_lock:
            self.tokens_total += 1

    def _step_once(self) -> None:
        eng = self.engine
        t0 = time.monotonic()
        results, evicted = eng.step()
        dt = time.monotonic() - t0
        _lm.observe_inter_token(dt)
        _lm.count_decode_dispatch(1)
        _lm.count_tokens(len(results))
        with self._stats_lock:
            self._inter_token_s.append(dt)
            self.decode_dispatches_total += 1
            self.tokens_total += len(results)
        for ev in evicted:
            self._requeue_evicted(ev)
        for sid, tok, fin in results:
            self._push_token(sid, tok, fin)
        pool, resident = eng.pool_used_ratio(), eng.resident_tokens()
        _lm.set_pool_used(pool)
        _lm.set_resident_tokens(resident)
        with self._stats_lock:
            self.pool_used_ratio = pool
            self.resident_tokens = resident

    def _requeue_evicted(self, ev: Dict[str, Any]) -> None:
        _lm.count_preemption()
        with self._stats_lock:
            self.preemptions_total += 1
        st = self._live.get(ev["seq_id"])
        if st is None:  # stream already gone; drop silently
            return
        req = {"query_id": st["query_id"], "tokens": ev["tokens"],
               "max_new": ev["max_new"], "n_done": ev["n_done"],
               "temperature": ev["temperature"], "seed": ev["seed"],
               "eos": ev["eos"], "seq_id": ev["seq_id"],
               "t0": time.monotonic()}
        with self._cv:
            self._pending.appendleft(req)

    # --- frame plumbing ---

    def _push_token(self, sid: Any, tok: int,
                    fin: Optional[str]) -> None:
        st = self._live.get(sid)
        if st is None:
            return
        frame: Dict[str, Any] = {"seq": st["frame"], "tok": [int(tok)],
                                 "done": fin is not None}
        st["frame"] += 1
        st["n_sent"] += 1
        if fin is not None:
            frame["finish"] = fin
            frame["n_tokens"] = st["n_sent"]
            del self._live[sid]
            with self._stats_lock:
                self.served_total += 1
        self.frames.send_token_frame(st["query_id"], self.worker_id,
                                     frame)

    def _finish_frame(self, sid: Any, fin: str) -> None:
        st = self._live.pop(sid, None)
        if st is None:
            return
        with self._stats_lock:
            self.served_total += 1
        self.frames.send_token_frame(
            st["query_id"], self.worker_id,
            {"seq": st["frame"], "tok": [], "done": True,
             "finish": fin, "n_tokens": st["n_sent"]})

    def _error_frame(self, query_id: str, msg: str) -> None:
        if not query_id:
            return
        self.frames.send_token_frame(
            query_id, self.worker_id,
            {"seq": 0, "tok": [], "done": True, "finish": "error",
             "error": msg, "n_tokens": 0})

    def close(self, join: Optional[threading.Thread] = None,
              timeout: float = 5.0) -> None:
        """Stop the loop (joining ``join`` when given) and release the
        engine's device pages."""
        self.stop()
        if join is not None:
            join.join(timeout=timeout)
        self.engine.close()
