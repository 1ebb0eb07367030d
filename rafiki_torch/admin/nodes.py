"""Cluster node registry: each node's identity and cards over the bus.

The port's copy of ``rafiki_tpu/admin/nodes.py``. Each node's
``ServicesManager`` announces one record on the serving bus under
``n:{node_id}`` (host, pid, cards, the node's broker URI and a heartbeat
stamp), riding the platform's existing heartbeat, so the registry adds
no thread. ``GET /nodes``, the relay wiring (``relay_peers``) and the
spread vote (``spread_ok``) read the records back.

The platform builds one only with the cluster fabric on
(``RAFIKI_TPU_CLUSTER_FABRIC``); off, ``services.node_registry`` stays
None: no ``rafiki_tpu_node_*`` series and no registry traffic.

A record is live while its heartbeat is younger than ``lease_s`` (the
node lease): a node that died without withdrawing stops counting one
lease later.

``spread_ok`` is the autoscaler's vote (``admin/autoscaler.py``
``_scale_up``): one placing node a pressure round.
"""

from __future__ import annotations

import logging
import os
import socket
import time
from typing import Any, Callable, Dict, List

from ..observe import metrics as _metrics

_log = logging.getLogger(__name__)

#: The kv prefix of node records (beside the workers' ``w:`` keys).
NODE_KEY_PREFIX = "n:"


def node_key(node_id: str) -> str:
    return f"{NODE_KEY_PREFIX}{node_id}"


class NodeRegistry:
    """One node's view of the cluster's membership. ``bus_factory``
    returns the serving bus (``ServicesManager.serving_bus``), called at
    each use, so building the registry opens no connection."""

    def __init__(self, bus_factory: Callable[[], Any], node_id: str,
                 n_chips: int = 0, bus_uri: str = "",
                 lease_s: float = 120.0):
        self._bus_factory = bus_factory
        self.node_id = node_id
        self.n_chips = int(n_chips or 0)
        # This node's broker, published so peers can wire their relay.
        self.bus_uri = bus_uri
        self.lease_s = float(lease_s)
        self._peers_gauge = None
        if _metrics.metrics_enabled():
            self._peers_gauge = _metrics.registry().gauge(
                "rafiki_tpu_node_peers",
                "Nodes with a fresh heartbeat in the cluster node "
                "registry, as seen by this node")

    # --- Write side (rides ServicesManager.heartbeat) ---

    def announce(self) -> None:
        """Write or refresh this node's record."""
        rec = {"node": self.node_id, "host": socket.gethostname(),
               "pid": os.getpid(), "chips": self.n_chips,
               "bus": self.bus_uri, "hb": time.time()}
        self._bus_factory().set(node_key(self.node_id), rec)
        if self._peers_gauge is not None:
            self._peers_gauge.set(float(len(self.live_nodes())))

    def withdraw(self) -> None:
        """Delete this node's record (a leaving node must not count for
        a lease)."""
        try:
            self._bus_factory().delete(node_key(self.node_id))
        except (ConnectionError, OSError, RuntimeError):
            pass  # the broker is gone, and the record with it

    # --- Read side ---

    def nodes(self) -> Dict[str, Dict[str, Any]]:
        """Each registered node's record, with its heartbeat's age and
        whether it is live."""
        bus = self._bus_factory()
        now = time.time()
        out: Dict[str, Dict[str, Any]] = {}
        for key in bus.keys(prefix=NODE_KEY_PREFIX):
            rec = bus.get(key)
            if not isinstance(rec, dict):
                continue
            nid = str(rec.get("node") or key[len(NODE_KEY_PREFIX):])
            try:
                age = max(0.0, now - float(rec.get("hb") or 0.0))
            except (TypeError, ValueError):
                age = float("inf")
            out[nid] = {
                "host": rec.get("host"), "pid": rec.get("pid"),
                "chips": rec.get("chips"), "bus": rec.get("bus"),
                "heartbeat_age_s": round(min(age, 1e9), 1),
                "live": age <= self.lease_s,
            }
        return out

    def live_nodes(self) -> List[str]:
        return sorted(n for n, r in self.nodes().items() if r["live"])

    def relay_peers(self) -> Dict[str, str]:
        """``node_id -> broker URI`` of every OTHER live node, what
        ``BusServer.add_peer`` is wired from."""
        return {n: str(r["bus"]) for n, r in self.nodes().items()
                if r["live"] and r.get("bus") and n != self.node_id}

    def spread_ok(self, replicas_by_node: Dict[str, int]) -> bool:
        """The failure-domain vote for one bin's scale-up: place here
        when this node holds the fewest replicas among the live nodes
        and is the first such node in sorted order, so exactly one node
        acts each round. A registry that cannot see this node votes
        True: spread is a preference, never a gate."""
        live = self.live_nodes()
        if not live or self.node_id not in live:
            return True
        counts = {n: int(replicas_by_node.get(n, 0)) for n in live}
        lo = min(counts.values())
        if counts[self.node_id] > lo:
            return False
        leaders = sorted(n for n, c in counts.items() if c == lo)
        return leaders[0] == self.node_id

    # --- Surfaces ---

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /nodes`` body."""
        return {"enabled": True, "node_id": self.node_id,
                "lease_s": self.lease_s, "nodes": self.nodes()}

    def health(self) -> Dict[str, Any]:
        """The fold into ``GET /status``."""
        nodes = self.nodes()
        return {"fabric": True, "nodes_registered": len(nodes),
                "nodes_live": sum(1 for r in nodes.values() if r["live"])}

    def close(self) -> None:
        """Withdraw and drop the registry's series (shutdown)."""
        self.withdraw()
        if self._peers_gauge is not None:
            self._peers_gauge.remove()
            self._peers_gauge = None
