"""Cache: the serving data plane's queue conventions over the bus.

The port's copy of ``Cache`` from ``rafiki_tpu/cache.py``:

- queries: ``q:{worker_id}`` (predictor -> one inference worker);
- replies: ``r:{batch_id}`` (workers -> the waiting predictor), and the
  token frames of a generate request on ``r:{query_id}``;
- registry: ``w:{inference_job_id}:{worker_id}`` -> worker info (kv).

Numpy queries ride the bus base64-framed, one ``__nd__`` frame per
array. When every query of a shard is an array of one shape and dtype
and its worker advertises ``"wire": ["ndbatch1"]``, the shard rides as
ONE ``__ndbatch__`` frame: a contiguous buffer with a shape, dtype and
offsets header (``PackedBatch``). A query frame carrying
``"rw": ["ndbatch1"]`` lets the worker pack its reply the same way
(``pack_prediction_rows``). The frames are the reference's byte for
byte, the packed wire always on (the reference's default), so the two
packages decode each other's frames.

``TokenFrames`` is a ``Cache`` over a bus of its own: the reply queues
of an in-process worker's generate requests.

The reference's trace and tenant envelopes, wire-byte counters,
frontend registry, cross-node relay, restack and profile markers, and
single-query frames are not ported.
"""

from __future__ import annotations

import base64
import binascii
import logging
import math
import threading
import time
import uuid
from typing import Any, Collection, Dict, List, Optional

import numpy as np

from .bus import BaseBus, MemoryBus

_log = logging.getLogger(__name__)

#: Negotiation token of the packed batch-tensor wire format.
WIRE_NDBATCH = "ndbatch1"

#: Upper bound on the per-query error replies a corrupt packed frame's
#: (untrusted) header can demand.
_CORRUPT_REPLY_CAP = 4096

#: Drain marker frame key: a worker popping a frame with this key
#: serves the burst in hand and exits its serve loop cleanly.
DRAIN_KEY = "__drain__"


def encode_payload(value: Any) -> Any:
    """JSON-safe encoding; numpy arrays -> base64 frames."""
    if isinstance(value, np.ndarray):
        return {"__nd__": base64.b64encode(
                    np.ascontiguousarray(value).tobytes()).decode(),
                "dtype": str(value.dtype), "shape": list(value.shape)}
    if isinstance(value, (list, tuple)):
        return [encode_payload(v) for v in value]
    if isinstance(value, dict):
        return {k: encode_payload(v) for k, v in value.items()}
    if isinstance(value, (np.integer, np.floating)):
        return value.item()
    return value


def decode_payload(value: Any) -> Any:
    if isinstance(value, dict):
        if "__nd__" in value:
            arr = np.frombuffer(base64.b64decode(value["__nd__"]),
                                dtype=np.dtype(value["dtype"]))
            return arr.reshape(value["shape"]).copy()
        return {k: decode_payload(v) for k, v in value.items()}
    if isinstance(value, list):
        return [decode_payload(v) for v in value]
    return value


class PackedBatch:
    """A batch of same-shape arrays as ONE C-contiguous buffer; ``slice``
    cuts a shard's wire frame out of it with one base64 encode."""

    __slots__ = ("data",)

    def __init__(self, data: np.ndarray):
        self.data = data  # (n, *query_shape), C-contiguous

    @property
    def n(self) -> int:
        return int(self.data.shape[0])

    @classmethod
    def from_arrays(cls, arrays: List[Any]) -> Optional["PackedBatch"]:
        """Pack a list of arrays, or None when they are not packable
        (mixed shapes or dtypes, non-arrays, empty)."""
        if not arrays:
            return None
        first = arrays[0]
        if not isinstance(first, np.ndarray) or first.dtype.hasobject \
                or first.dtype.itemsize == 0:
            return None
        shape, dtype = first.shape, first.dtype
        for a in arrays[1:]:
            if not isinstance(a, np.ndarray) or a.shape != shape \
                    or a.dtype != dtype:
                return None
        buf = np.empty((len(arrays), *shape), dtype)
        for i, a in enumerate(arrays):
            buf[i] = a
        return cls(buf)

    @classmethod
    def from_encoded(cls, encoded: List[Any]) -> Optional["PackedBatch"]:
        """Pack a list of ``__nd__`` wire frames (a request's body), or
        None when they are not all frames of one shape and dtype. The
        header is untrusted: the buffer is allocated only after the
        first payload's length vouches for it."""
        if not encoded:
            return None
        first = encoded[0]
        if not isinstance(first, dict) or "__nd__" not in first:
            return None
        try:
            dtype = np.dtype(first["dtype"])
            shape = tuple(int(x) for x in first["shape"])
        except (KeyError, TypeError, ValueError):
            return None
        if dtype.hasobject or dtype.itemsize == 0 \
                or any(s < 0 for s in shape):
            return None
        per = dtype.itemsize * int(math.prod(shape))
        buf = None
        for i, q in enumerate(encoded):
            if not isinstance(q, dict) or "__nd__" not in q:
                return None
            if q is not first and (
                    q.get("dtype") != first["dtype"]
                    or list(q.get("shape") or ()) != list(first["shape"])):
                return None
            try:
                raw = base64.b64decode(q["__nd__"])
            except (TypeError, binascii.Error):
                return None
            if len(raw) != per:
                return None
            if buf is None:
                buf = np.empty((len(encoded), *shape), dtype)
            buf[i] = np.frombuffer(raw, dtype=dtype).reshape(shape)
        return cls(buf)

    def slice(self, start: int, count: int) -> Dict[str, Any]:
        """One shard's wire frame: the header and one base64 encode of
        the contiguous row range."""
        rows = self.data[start:start + count]
        per = int(self.data.dtype.itemsize
                  * math.prod(self.data.shape[1:]))
        return {"__ndbatch__": base64.b64encode(rows.tobytes()).decode(),
                "v": 1,
                "dtype": str(self.data.dtype),
                "shape": list(self.data.shape[1:]),
                "n": count,
                "offsets": [i * per for i in range(count)]}


def pack_prediction_rows(predictions: List[Any],
                         ) -> Optional[Dict[str, Any]]:
    """One reply batch's prediction vectors as a single ``__ndbatch__``
    frame, or None when the batch is not packable: fewer than two rows,
    mixed shapes, error dicts, ``__members__`` envelopes, non-float
    outputs. Only 1-D float vectors (class probabilities) pack."""
    if len(predictions) < 2:
        return None
    rows: List[np.ndarray] = []
    shape = dtype = None
    for p in predictions:
        if isinstance(p, np.ndarray):
            a = p
        elif isinstance(p, (list, tuple)) and len(p) >= 2:
            try:
                a = np.asarray(p)
            except (ValueError, TypeError):
                return None
        else:
            return None
        if a.ndim != 1 or a.shape[0] < 2 or a.dtype.kind != "f":
            return None
        if shape is None:
            shape, dtype = a.shape, a.dtype
        elif a.shape != shape or a.dtype != dtype:
            return None
        rows.append(a)
    packed = PackedBatch.from_arrays(rows)
    return packed.slice(0, packed.n) if packed is not None else None


def decode_batch(value: Dict[str, Any]) -> np.ndarray:
    """Strict decode of one ``__ndbatch__`` frame into an ``(n,
    *shape)`` array (a read-only view of one base64 decode). Raises
    ``ValueError`` on any disagreement between header and payload: a
    truncated or corrupt frame is refused, never served as wrong
    tensors."""
    if not isinstance(value, dict) or "__ndbatch__" not in value:
        raise ValueError("not a packed batch frame")
    if value.get("v") != 1:
        raise ValueError(f"unsupported packed-frame version "
                         f"{value.get('v')!r}")
    try:
        dtype = np.dtype(value["dtype"])
        shape = tuple(int(x) for x in value["shape"])
        n = int(value["n"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed packed-frame header: {e}") from None
    if n < 0 or any(s < 0 for s in shape) or dtype.hasobject:
        raise ValueError("malformed packed-frame header")
    per = dtype.itemsize * int(math.prod(shape))
    offsets = value.get("offsets")
    if offsets is not None:
        try:
            bad = len(offsets) != n or any(
                int(offsets[i]) != i * per for i in range(n))
        except (TypeError, ValueError, KeyError, IndexError):
            bad = True
        if bad:
            raise ValueError("packed-frame offsets disagree with the "
                             "shape/dtype header")
    try:
        raw = base64.b64decode(value["__ndbatch__"], validate=True)
    except (TypeError, binascii.Error) as e:
        raise ValueError(f"corrupt packed payload: {e}") from None
    if len(raw) != n * per:
        raise ValueError(
            f"packed payload is {len(raw)} bytes; header claims "
            f"{n} x {per}")
    return np.frombuffer(raw, dtype=dtype).reshape((n, *shape))


class Cache:
    # A reply landing after its gather timed out (and deleted the queue)
    # recreates the queue with nobody left to pop it; deferred reaping
    # sweeps those orphans on later gathers.
    _REAP_DELAY = 60.0

    def __init__(self, bus: BaseBus):
        self.bus = bus
        self._reap_later: List[tuple] = []  # (monotonic_ts, queue_key)
        self._reap_lock = threading.Lock()

    def _reap_stale(self, now: float) -> None:
        with self._reap_lock:
            due = [key for ts, key in self._reap_later
                   if now - ts >= self._REAP_DELAY]
            self._reap_later = [(ts, key) for ts, key in self._reap_later
                                if now - ts < self._REAP_DELAY]
        for key in due:
            self.bus.delete_queue(key)

    # --- Worker registry ---

    def register_worker(self, inference_job_id: str, worker_id: str,
                        info: Optional[Dict[str, Any]] = None) -> None:
        self.bus.set(f"w:{inference_job_id}:{worker_id}", info or {})

    def unregister_worker(self, inference_job_id: str,
                          worker_id: str) -> None:
        self.bus.delete(f"w:{inference_job_id}:{worker_id}")

    def running_workers(self, inference_job_id: str) -> List[str]:
        prefix = f"w:{inference_job_id}:"
        return [k[len(prefix):] for k in self.bus.keys(prefix)]

    def running_worker_info(self, inference_job_id: str,
                            ) -> Dict[str, Dict[str, Any]]:
        """worker_id -> registration info (the trial bin it serves, its
        wire formats, its engine geometry when it generates)."""
        prefix = f"w:{inference_job_id}:"
        return {k[len(prefix):]: self.bus.get(k) or {}
                for k in self.bus.keys(prefix)}

    # --- Query shards (predictor side) ---

    def send_query_shards(self, shards: List[tuple],
                          encoded_queries: Optional[List[Any]],
                          batch_id: Optional[str] = None,
                          packed: Optional[PackedBatch] = None,
                          packed_ok: Collection[str] = ()) -> str:
        """Scatter slices of one batch in one ``push_many``. ``shards``
        is ``[(worker_id, start, count, shard_id), ...]``; each frame
        carries its slice and the ``shard`` id its worker echoes back.
        A shard bound for a worker in ``packed_ok`` carries its slice as
        one packed ``batch`` frame; the others the per-query list
        (``encoded_queries``, which may be None only when every worker
        is in ``packed_ok``)."""
        batch_id = batch_id or uuid.uuid4().hex
        n = packed.n if packed is not None else len(encoded_queries)
        frames = []
        for worker_id, start, count, shard_id in shards:
            frame: Dict[str, Any] = {"batch_id": batch_id,
                                     "shard": shard_id,
                                     "rw": [WIRE_NDBATCH]}
            if packed is not None and worker_id in packed_ok:
                frame["batch"] = packed.slice(start, count)
            else:
                frame["queries"] = (
                    encoded_queries if start == 0 and count == n
                    else encoded_queries[start:start + count])
            frames.append((f"q:{worker_id}", frame))
        self.bus.push_many(frames)
        return batch_id

    def gather_prediction_batches(self, batch_id: str, n_workers: int,
                                  timeout: float = 5.0,
                                  ) -> List[Dict[str, Any]]:
        """Collect up to ``n_workers`` batch replies within ``timeout``,
        then drop the reply queue. A packed reply decodes into per-row
        vectors; a corrupt one is dropped, so its shard reads as
        unanswered."""
        now = time.monotonic()
        self._reap_stale(now)
        queue = f"r:{batch_id}"
        out: List[Dict[str, Any]] = []
        deadline = now + timeout
        while len(out) < n_workers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            item = self.bus.pop(queue, timeout=remaining)
            if item is None:
                break
            if "batch" in item:
                try:
                    arr = decode_batch(item.pop("batch"))
                except ValueError:
                    _log.warning("corrupt packed reply for batch %s "
                                 "dropped", batch_id, exc_info=True)
                    continue
                item["predictions"] = [arr[i] for i in range(arr.shape[0])]
            else:
                item["predictions"] = [decode_payload(p)
                                       for p in item["predictions"]]
            out.append(item)
        self.bus.delete_queue(queue)
        if len(out) < n_workers:
            # A straggler may still reply and recreate the queue.
            with self._reap_lock:
                self._reap_later.append((time.monotonic(), queue))
        return out

    # --- Graceful drain ---

    def send_drain(self, worker_id: str) -> None:
        """Queue a drain marker: the worker serves everything enqueued
        BEFORE it, then exits its serve loop cleanly."""
        self.bus.push(f"q:{worker_id}", {DRAIN_KEY: 1})

    # --- Queries (inference worker side) ---

    def pop_queries(self, worker_id: str, max_items: int = 0,
                    timeout: float = 1.0) -> List[Dict[str, Any]]:
        """Blocking batched pop: waits for the first item, drains the
        burst. A packed ``batch`` is decoded here to an ``(n, *shape)``
        array; a corrupt one becomes ``batch=None`` with ``batch_error``
        and the header's ``n`` (capped), and the worker answers it with
        per-query errors instead of failing."""
        items = self.bus.pop_all(f"q:{worker_id}", max_items=max_items,
                                 timeout=timeout)
        for it in items:
            if DRAIN_KEY in it or it.get("op") == "generate":
                continue  # a marker, or a token request routed whole
            if "batch" in it:
                raw = it["batch"]
                try:
                    it["batch"] = decode_batch(raw)
                except ValueError as e:
                    it["batch"] = None
                    it["batch_error"] = str(e)
                    try:
                        it["n"] = max(0, min(int(raw.get("n", 0)),
                                             _CORRUPT_REPLY_CAP))
                    except (AttributeError, TypeError, ValueError):
                        it["n"] = 0
            else:
                it["queries"] = [decode_payload(q) for q in it["queries"]]
        return items

    def send_prediction_batch(self, batch_id: str, worker_id: str,
                              predictions: List[Any], weight: int = 1,
                              shard: Optional[Any] = None,
                              packed_ok: bool = False) -> None:
        """``weight`` is how many ensemble members this reply already
        averages (a worker serving a bin of several trials reports more
        than 1, so the predictor's mean stays unweighted over trials).
        ``shard`` echoes the query frame's shard id. ``packed_ok`` (the
        query frame advertised ``rw``) lets dense float rows ride one
        packed frame."""
        frame: Dict[str, Any] = {"worker_id": worker_id,
                                 "weight": int(weight)}
        packed_frame = (pack_prediction_rows(predictions)
                        if packed_ok else None)
        if packed_frame is not None:
            frame["batch"] = packed_frame
        else:
            frame["predictions"] = [encode_payload(p) for p in predictions]
        if shard is not None:
            frame["shard"] = shard
        self.bus.push(f"r:{batch_id}", frame)

    # --- Generative serving (token streaming) ---
    #
    # A generate request is ONE frame on the worker's query queue
    # (op="generate"); the reply is MANY frames on r:{query_id}, one per
    # decode step that produced a token for it, each with a rising
    # "seq", the last marked done (finish "eos", "length" or "error").

    def send_generate(self, worker_id: str, tokens: List[int], *,
                      max_new: int, temperature: float = 0.0,
                      seed: int = 0, eos: Optional[int] = None,
                      query_id: Optional[str] = None) -> str:
        """Queue one token-generation request on ``worker_id``'s query
        queue; its token frames stream back on ``r:{query_id}``."""
        query_id = query_id or uuid.uuid4().hex
        self.bus.push(f"q:{worker_id}", {
            "query_id": query_id, "op": "generate",
            "gen": {"tokens": [int(t) for t in tokens],
                    "max_new": int(max_new),
                    "temperature": float(temperature),
                    "seed": int(seed),
                    "eos": int(eos) if eos is not None else None}})
        return query_id

    def send_token_frame(self, query_id: str, worker_id: str,
                         frame: Dict[str, Any]) -> None:
        """Push one token frame (worker side), stamped with the worker
        that produced it."""
        self.bus.push(f"r:{query_id}", dict(frame, worker_id=worker_id))

    def pop_token_frames(self, query_id: str, timeout: float = 1.0,
                         max_items: int = 0) -> List[Dict[str, Any]]:
        """Every token frame that has arrived for one generate request,
        waiting up to ``timeout`` seconds for the first; an empty list
        when none came."""
        return self.bus.pop_all(f"r:{query_id}", max_items=max_items,
                                timeout=timeout)


class TokenFrames(Cache):
    """The token-frame queues of an in-process worker: a ``Cache`` over
    a ``MemoryBus`` of its own."""

    def __init__(self):
        super().__init__(MemoryBus())
