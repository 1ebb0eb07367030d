"""Cache: the serving data plane's queue conventions over the bus.

The port's copy of ``Cache`` from ``rafiki_tpu/cache.py``:

- queries: ``q:{worker_id}`` (predictor -> one inference worker);
- replies: ``r:{batch_id}`` (workers -> the waiting predictor), and the
  token frames of a generate request on ``r:{query_id}``;
- registry: ``w:{inference_job_id}:{worker_id}`` -> worker info (kv),
  and on the cluster fabric ``f:{inference_job_id}:{instance}`` -> a
  predictor frontend's HTTP address (``register_frontend``), which peer
  frontends probe and the admin's invalidation fans out to.

Numpy queries ride the bus base64-framed, one ``__nd__`` frame per
array. When every query of a shard is an array of one shape and dtype
and its worker advertises ``"wire": ["ndbatch1"]``, the shard rides as
ONE ``__ndbatch__`` frame: a contiguous buffer with a shape, dtype and
offsets header (``PackedBatch``). A query frame carrying
``"rw": ["ndbatch1"]`` lets the worker pack its reply the same way
(``pack_prediction_rows``). The frames are the reference's byte for
byte, so the two packages decode each other's frames. The packed wire
is ``RAFIKI_TPU_SERVING_PACKED_WIRE`` (``observe.wire``), read when a
``Cache`` is built: with ``off`` or ``compat`` its query frames carry
no ``rw`` and its replies are per-query, whatever the frame asked.

The reference's per-query calls are here too: ``send_query`` pushes
one query (``{"query_id", "query"}``) that the worker answers with
``send_prediction`` on ``r:{query_id}``, which ``gather_predictions``
collects; ``send_query_batch`` and ``send_query_batch_fanout`` scatter
one whole batch to one worker or to several.

A query frame carries the ``"_trace"`` envelope (``observe.trace``)
of the requests it serves: the contexts the caller passes, else the
calling thread's, else none. A sharded gather pops one reply at a time
(``n_workers=1``), keeps the reply queue alive between rounds
(``reap=False``, closed by ``reap_reply_queue``) and stamps each reply
with its arrival time (``timestamps=True``).

A query frame also carries the ``"_tenant"`` envelope
(``observe.attribution``) of the tenants whose queries it holds, scaled
to each shard's slice, when the attribution ledger is on. A reply frame
carries each query's ``confidence`` (a worker serving a tiering
predictor sends it) and ``compute_s``, the worker's device seconds for
its slice. Every send counts its estimated bytes, and every decode its
host copy, in the serving wire series (``observe.wire``).

Three control markers ride a worker's query queue, so they apply in
queue order: ``__drain__`` (serve what came before, then exit),
``__restack__`` (swap one member of a stacked bin in place, after
serving what came before, ``send_restack``) and ``__profile__`` (start
a bounded device profile between bursts, ``send_profile``).

``TokenFrames`` is a ``Cache`` over a bus of its own: the reply queues
of an in-process worker's generate requests.

Across nodes (the cluster fabric), ``send_query_shards`` given a
worker-to-node map sends the shards bound for another node's workers
through the bus relay, one ``relay_push_many`` (one inter-node hop) a
node, each frame stamped ``onode`` with the sender's node; the worker's
``send_prediction_batch(..., origin_node=)`` relays its reply back to
that node's broker. Without the map every frame takes the plain
``push_many``.
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
from .observe import attribution as _attr
from .observe import trace as _trace
from .observe import wire as _wire

_log = logging.getLogger(__name__)

#: Negotiation token of the packed batch-tensor wire format.
WIRE_NDBATCH = "ndbatch1"

#: Upper bound on the per-query error replies a corrupt packed frame's
#: (untrusted) header can demand.
_CORRUPT_REPLY_CAP = 4096

#: Drain marker frame key: a worker popping a frame with this key
#: serves the burst in hand and exits its serve loop cleanly.
DRAIN_KEY = "__drain__"

#: Restack marker frame key: a worker popping a frame with this key
#: swaps one member of its stacked bin after serving the burst in hand.
RESTACK_KEY = "__restack__"

#: On-demand profiling marker (``Admin.profile_inference_job``): the
#: worker starts a bounded ``torch.profiler`` session between bursts,
#: in queue order like the drain and restack markers, so the session
#: observes real serving traffic without pausing it.
PROFILE_KEY = "__profile__"


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


def _payload_nbytes(value: Any) -> int:
    """An estimate of a wire payload's serialized bytes (base64 lengths
    plus a nominal framing overhead), made without serializing it."""
    if isinstance(value, dict):
        s = value.get("__nd__")
        if isinstance(s, str):
            return len(s) + 48
        s = value.get("__ndbatch__")
        if isinstance(s, str):
            return len(s) + 64 + 12 * int(value.get("n", 0) or 0)
        return 32 + sum(_payload_nbytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return 2 + sum(_payload_nbytes(v) for v in value)
    if isinstance(value, str):
        return len(value) + 2
    if isinstance(value, float):
        return 18
    return 8


def _trace_envelope(trace_ctxs: Optional[List] = None) -> Optional[Dict]:
    """The ``_trace`` field of an outgoing query frame: the contexts
    given (the micro-batcher's scatter), else the calling thread's (the
    direct path), else None (no envelope)."""
    if trace_ctxs is None:
        cur = _trace.current()
        trace_ctxs = [cur] if cur is not None else []
    return _trace.inject(trace_ctxs)


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
        _wire.count_copies("assemble", len(arrays))
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
        _wire.count_copies("decode", len(encoded))
        return cls(buf)

    def slice(self, start: int, count: int) -> Dict[str, Any]:
        """One shard's wire frame: the header and one base64 encode of
        the contiguous row range (one ``encode`` copy)."""
        rows = self.data[start:start + count]
        _wire.count_copies("encode", 1)
        per = int(self.data.dtype.itemsize
                  * math.prod(self.data.shape[1:]))
        return {"__ndbatch__": base64.b64encode(rows.tobytes()).decode(),
                "v": 1,
                "dtype": str(self.data.dtype),
                "shape": list(self.data.shape[1:]),
                "n": count,
                "offsets": [i * per for i in range(count)]}

    def take(self, indices: List[int]) -> "PackedBatch":
        """The rows ``indices`` as a packed batch of their own (the
        tiered path's escalation subset)."""
        return PackedBatch(np.ascontiguousarray(self.data[indices]))


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
        # Read once: "on" lets this side's query frames ask for packed
        # replies (rw) and its replies pack when asked.
        self._packed_wire_on = _wire.packed_wire_mode() == "on"

    def _reap_stale(self, now: float) -> None:
        with self._reap_lock:
            due = [key for ts, key in self._reap_later
                   if now - ts >= self._REAP_DELAY]
            self._reap_later = [(ts, key) for ts, key in self._reap_later
                                if now - ts < self._REAP_DELAY]
        for key in due:
            self.bus.delete_queue(key)

    def _gather(self, queue_key: str, n_workers: int, timeout: float,
                decode: Any, reap: bool = True,
                timestamps: bool = False) -> List[Dict[str, Any]]:
        """Pop up to ``n_workers`` replies off a one-shot reply queue,
        then drop it; a straggler's reply is swept later. ``reap=False``
        keeps the queue (the sharded gather pops again after a
        resubmit, and a delete between rounds could lose a reply in
        flight); ``timestamps=True`` stamps each reply's monotonic
        arrival as ``"_recv_mono"``."""
        now = time.monotonic()
        self._reap_stale(now)
        out: List[Dict[str, Any]] = []
        deadline = now + timeout
        while len(out) < n_workers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            item = self.bus.pop(queue_key, timeout=remaining)
            if item is None:
                break
            item = decode(item)
            if item is None:
                continue  # a corrupt packed reply, dropped
            if timestamps:
                item["_recv_mono"] = time.monotonic()
            out.append(item)
        if not reap:
            return out
        self.bus.delete_queue(queue_key)
        if len(out) < n_workers:
            with self._reap_lock:
                self._reap_later.append((time.monotonic(), queue_key))
        return out

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

    # --- Frontend registry (the cluster fabric) ---

    def register_frontend(self, inference_job_id: str, instance: str,
                          addr: str) -> None:
        self.bus.set(f"f:{inference_job_id}:{instance}", addr)

    def unregister_frontend(self, inference_job_id: str,
                            instance: str) -> None:
        self.bus.delete(f"f:{inference_job_id}:{instance}")

    def frontends(self, inference_job_id: str) -> Dict[str, str]:
        """instance -> HTTP address of each registered frontend."""
        prefix = f"f:{inference_job_id}:"
        out: Dict[str, str] = {}
        for k in self.bus.keys(prefix):
            addr = self.bus.get(k)
            if addr:
                out[k[len(prefix):]] = str(addr)
        return out

    # --- Queries (predictor side) ---

    def send_query(self, worker_id: str, query: Any,
                   query_id: Optional[str] = None) -> str:
        """Push one query to one worker; its reply comes back on
        ``r:{query_id}`` (``gather_predictions``)."""
        query_id = query_id or uuid.uuid4().hex
        frame = {"query_id": query_id, "query": encode_payload(query)}
        env = _trace_envelope()
        if env is not None:
            frame[_trace.ENVELOPE_KEY] = env
        self.bus.push(f"q:{worker_id}", frame)
        return query_id

    def gather_predictions(self, query_id: str, n_workers: int,
                           timeout: float = 5.0) -> List[Dict[str, Any]]:
        """Collect up to ``n_workers`` workers' replies to one query."""
        def decode(item):
            item["prediction"] = decode_payload(item["prediction"])
            return item

        return self._gather(f"r:{query_id}", n_workers, timeout, decode)

    def send_query_batch(self, worker_id: str, queries: List[Any],
                         batch_id: Optional[str] = None,
                         pre_encoded: bool = False,
                         trace_ctxs: Optional[List] = None) -> str:
        """Push one batch of queries to one worker as one frame;
        ``pre_encoded`` skips ``encode_payload`` for a caller that sends
        the same batch to several workers."""
        batch_id = batch_id or uuid.uuid4().hex
        if not pre_encoded:
            queries = [encode_payload(q) for q in queries]
        frame = {"batch_id": batch_id, "queries": queries}
        if self._packed_wire_on:
            frame["rw"] = [WIRE_NDBATCH]
        env = _trace_envelope(trace_ctxs)
        if env is not None:
            frame[_trace.ENVELOPE_KEY] = env
        self.bus.push(f"q:{worker_id}", frame)
        return batch_id

    def send_query_batch_fanout(self, worker_ids: List[str],
                                encoded_queries: Optional[List[Any]],
                                batch_id: Optional[str] = None,
                                trace_ctxs: Optional[List] = None,
                                packed: Optional[PackedBatch] = None,
                                packed_ok: Collection[str] = (),
                                tenants: Optional[List] = None,
                                ) -> str:
        """Scatter one pre-encoded batch to every worker in one
        ``push_many``; the encoded list is shared by the frames, never
        copied. A worker in ``packed_ok`` gets the whole batch as one
        packed ``batch`` frame (encoded once for all of them), the rest
        the per-query list (``encoded_queries``, None only when every
        worker is in ``packed_ok``). ``tenants`` rides every frame as
        the ``_tenant`` envelope."""
        batch_id = batch_id or uuid.uuid4().hex
        env = _trace_envelope(trace_ctxs)
        tenant_env = _attr.inject_tenants(tenants)
        counting = _wire.counting()
        packed_frame = None
        if packed is not None and any(w in packed_ok for w in worker_ids):
            packed_frame = packed.slice(0, packed.n)
        frames = []
        for w in worker_ids:
            frame: Dict[str, Any] = {"batch_id": batch_id}
            if self._packed_wire_on:
                frame["rw"] = [WIRE_NDBATCH]
            if packed_frame is not None and w in packed_ok:
                frame["batch"] = packed_frame
                if counting:
                    _wire.count_bytes("packed", "scatter",
                                      _payload_nbytes(packed_frame))
            else:
                frame["queries"] = encoded_queries
                if counting:
                    _wire.count_bytes("perquery", "scatter",
                                      _payload_nbytes(encoded_queries))
            if env is not None:
                frame[_trace.ENVELOPE_KEY] = env
            if tenant_env is not None:
                frame[_attr.ENVELOPE_KEY] = tenant_env
            frames.append((f"q:{w}", frame))
        self.bus.push_many(frames)
        return batch_id

    # --- Query shards (predictor side) ---

    def send_query_shards(self, shards: List[tuple],
                          encoded_queries: Optional[List[Any]],
                          batch_id: Optional[str] = None,
                          trace_ctxs: Optional[List] = None,
                          packed: Optional[PackedBatch] = None,
                          packed_ok: Collection[str] = (),
                          tenants: Optional[List] = None,
                          worker_nodes: Optional[Dict[str, str]] = None,
                          local_node: str = "") -> str:
        """Scatter slices of one batch in one ``push_many``. ``shards``
        is ``[(worker_id, start, count, shard_id), ...]``; each frame
        carries its slice and the ``shard`` id its worker echoes back.
        A shard bound for a worker in ``packed_ok`` carries its slice as
        one packed ``batch`` frame; the others the per-query list
        (``encoded_queries``, which may be None only when every worker
        is in ``packed_ok``). ``trace_ctxs`` are the coalesced
        requests' trace contexts (the envelope). ``tenants``, the batch's
        ``[(tenant, n_queries), ...]``, rides each frame scaled down to
        its slice (rounded down: a share that rounds to nothing goes
        unattributed rather than overcounted). With ``worker_nodes``
        (worker -> node) and ``local_node``, the shards of a worker on
        another node go through the relay, one ``relay_push_many`` a
        node, stamped ``onode``; the rest take one ``push_many``."""
        batch_id = batch_id or uuid.uuid4().hex
        env = _trace_envelope(trace_ctxs)
        n = packed.n if packed is not None else len(encoded_queries)
        counting = _wire.counting()
        frames = []
        remote: Dict[str, List[tuple]] = {}
        for worker_id, start, count, shard_id in shards:
            frame: Dict[str, Any] = {"batch_id": batch_id,
                                     "shard": shard_id}
            if self._packed_wire_on:
                frame["rw"] = [WIRE_NDBATCH]
            wnode = (worker_nodes or {}).get(worker_id, "")
            if wnode and local_node and wnode != local_node:
                frame["onode"] = local_node
            if tenants:
                tenant_env = _attr.inject_tenants(
                    [(t, int(c * count / max(n, 1))) for t, c in tenants])
                if tenant_env is not None:
                    frame[_attr.ENVELOPE_KEY] = tenant_env
            if packed is not None and worker_id in packed_ok:
                frame["batch"] = packed.slice(start, count)
                if counting:
                    _wire.count_bytes("packed", "scatter",
                                      _payload_nbytes(frame["batch"]))
            else:
                frame["queries"] = (
                    encoded_queries if start == 0 and count == n
                    else encoded_queries[start:start + count])
                if counting:
                    _wire.count_bytes("perquery", "scatter",
                                      _payload_nbytes(frame["queries"]))
            if env is not None:
                frame[_trace.ENVELOPE_KEY] = env
            if "onode" in frame:
                remote.setdefault(wnode, []).append(
                    (f"q:{worker_id}", frame))
            else:
                frames.append((f"q:{worker_id}", frame))
        if frames:
            self.bus.push_many(frames)
        for wnode, items in remote.items():
            self.bus.relay_push_many(wnode, items)
        return batch_id

    def gather_prediction_batches(self, batch_id: str, n_workers: int,
                                  timeout: float = 5.0, reap: bool = True,
                                  timestamps: bool = False,
                                  ) -> List[Dict[str, Any]]:
        """Collect up to ``n_workers`` batch replies within ``timeout``
        (``reap`` and ``timestamps`` as ``_gather``). A packed reply
        decodes into per-row vectors; a corrupt one is dropped, so its
        shard reads as unanswered and may still be resubmitted."""
        def decode(item):
            if "batch" in item:
                try:
                    arr = decode_batch(item.pop("batch"))
                except ValueError:
                    _log.warning("corrupt packed reply for batch %s "
                                 "dropped", batch_id, exc_info=True)
                    return None
                item["predictions"] = [arr[i] for i in range(arr.shape[0])]
                _wire.count_copies("decode", 1)
            else:
                item["predictions"] = [decode_payload(p)
                                       for p in item["predictions"]]
            return item

        return self._gather(f"r:{batch_id}", n_workers, timeout, decode,
                            reap=reap, timestamps=timestamps)

    def reap_reply_queue(self, batch_id: str, defer: bool = True) -> None:
        """Finish a ``reap=False`` gather: drop the reply queue, and with
        ``defer`` sweep it again later, for a gather that ended with
        stragglers or resubmitted shards still able to reply."""
        self.bus.delete_queue(f"r:{batch_id}")
        if defer:
            with self._reap_lock:
                self._reap_later.append((time.monotonic(),
                                         f"r:{batch_id}"))

    # --- Graceful drain ---

    def send_drain(self, worker_id: str) -> None:
        """Queue a drain marker: the worker serves everything enqueued
        BEFORE it, then exits its serve loop cleanly."""
        self.bus.push(f"q:{worker_id}", {DRAIN_KEY: 1})

    def send_restack(self, worker_id: str, old_trial_id: str,
                     new_trial_id: str) -> None:
        """Queue a member swap for a stacked bin: the worker replaces
        ``old_trial_id``'s member with ``new_trial_id``'s in place and
        re-registers with the new bin. Every shard queued before the
        marker is answered by the old member set."""
        self.bus.push(f"q:{worker_id}", {RESTACK_KEY: {
            "old": str(old_trial_id), "new": str(new_trial_id)}})

    def send_profile(self, worker_id: str, out_dir: str,
                     duration_s: float) -> None:
        """Queue an on-demand profiling marker: the worker starts a
        bounded device profile into ``out_dir`` between bursts and its
        serve loop stops it once ``duration_s`` has passed. A worker
        whose profiler is busy skips the request."""
        self.bus.push(f"q:{worker_id}", {PROFILE_KEY: {
            "dir": str(out_dir), "duration_s": float(duration_s)}})

    # --- Queries (inference worker side) ---

    def pop_queries(self, worker_id: str, max_items: int = 0,
                    timeout: float = 1.0) -> List[Dict[str, Any]]:
        """Blocking batched pop: waits for the first item, drains the
        burst. An item is one query (``query``), a batch (``queries``)
        or a packed batch (``batch``), decoded here to an ``(n,
        *shape)`` array; a corrupt one becomes ``batch=None`` with
        ``batch_error`` and the header's ``n`` (capped), and the worker
        answers it with per-query errors instead of failing."""
        items = self.bus.pop_all(f"q:{worker_id}", max_items=max_items,
                                 timeout=timeout)
        counting = _wire.counting()
        for it in items:
            if DRAIN_KEY in it or RESTACK_KEY in it or PROFILE_KEY in it \
                    or it.get("op") == "generate":
                continue  # a marker, or a token request routed whole
            if "batch" in it:
                raw = it["batch"]
                try:
                    it["batch"] = decode_batch(raw)
                    _wire.count_copies("decode", 1)
                except ValueError as e:
                    it["batch"] = None
                    it["batch_error"] = str(e)
                    try:
                        it["n"] = max(0, min(int(raw.get("n", 0)),
                                             _CORRUPT_REPLY_CAP))
                    except (AttributeError, TypeError, ValueError):
                        it["n"] = 0
            elif "queries" in it:
                it["queries"] = [decode_payload(q) for q in it["queries"]]
                if counting:
                    _wire.count_copies("decode", sum(
                        1 for q in it["queries"]
                        if isinstance(q, np.ndarray)))
            else:
                it["query"] = decode_payload(it["query"])
        return items

    def send_prediction(self, query_id: str, worker_id: str,
                        prediction: Any, weight: int = 1) -> None:
        """Answer one ``send_query`` query; ``weight`` as in
        ``send_prediction_batch``."""
        self.bus.push(f"r:{query_id}", {
            "worker_id": worker_id, "weight": int(weight),
            "prediction": encode_payload(prediction)})

    def send_prediction_batch(self, batch_id: str, worker_id: str,
                              predictions: List[Any], weight: int = 1,
                              shard: Optional[Any] = None,
                              confidence: Optional[List] = None,
                              compute_s: Optional[float] = None,
                              packed_ok: bool = False,
                              origin_node: Optional[str] = None) -> None:
        """``weight`` is how many ensemble members this reply already
        averages (a worker serving a bin of several trials reports more
        than 1, so the predictor's mean stays unweighted over trials).
        ``shard`` echoes the query frame's shard id. ``confidence`` (a
        softmax margin a query, None where there is none) and
        ``compute_s`` (the slice's device seconds) feed the predictor's
        tiering and its chip-seconds-avoided estimate. ``packed_ok``
        (the query frame advertised ``rw``) lets dense float rows ride
        one packed frame, while this side's packed wire is on.
        ``origin_node`` (the query frame's ``onode``) relays the reply
        back to that node's broker."""
        frame: Dict[str, Any] = {"worker_id": worker_id,
                                 "weight": int(weight)}
        packed_frame = (pack_prediction_rows(predictions)
                        if packed_ok and self._packed_wire_on else None)
        if packed_frame is not None:
            frame["batch"] = packed_frame
            if _wire.counting():
                _wire.count_bytes("packed", "reply",
                                  _payload_nbytes(packed_frame))
        else:
            frame["predictions"] = [encode_payload(p) for p in predictions]
            if _wire.counting():
                _wire.count_bytes("perquery", "reply",
                                  _payload_nbytes(frame["predictions"]))
        if shard is not None:
            frame["shard"] = shard
        if confidence is not None and any(c is not None
                                          for c in confidence):
            frame["confidence"] = confidence
        if compute_s is not None:
            frame["compute_s"] = compute_s
        if origin_node:
            self.bus.relay_push(origin_node, f"r:{batch_id}", frame)
        else:
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
