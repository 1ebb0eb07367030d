"""Scraping the serving endpoints, grouped by node.

The port's copy of ``rafiki_tpu/admin/scrape.py``: one fetch of a
predictor's or a worker's endpoint (``fetch_endpoint``), the workers'
advertised ``/metrics`` addresses grouped by the node that placed them
(``worker_scrape_targets``, from the bus registry's ``metrics`` and
``node`` keys), their expositions merged with the failures counted
(``merge_worker_expositions``), and a per-sweep memo
(``ScrapeCache``), through which each endpoint is fetched once a sweep,
failures included.

Its consumers are the SLO engine's and the autoscaler's sweeps, which
ride the supervise sweep on one ``ScrapeCache``
(``ServicesManager._sweep_control_loop``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple


def fetch_endpoint(host: str, path: str, timeout: float = 5.0) -> Any:
    """One fetch: ``/metrics`` gives the exposition's text, any other
    path its JSON."""
    from urllib.request import urlopen

    with urlopen(f"http://{host}{path}", timeout=timeout) as resp:
        body = resp.read()
    if path == "/metrics":
        return body.decode()
    return json.loads(body)


def worker_metrics_addrs(services, job_id: str) -> List[str]:
    """The job's workers' advertised ``/metrics`` addresses, across
    nodes."""
    by_node, _ = worker_scrape_targets(services, job_id)
    return sorted({a for addrs in by_node.values() for a in addrs})


def worker_scrape_targets(services, job_id: str
                          ) -> Tuple[Dict[str, List[str]], int]:
    """``(node -> the workers' advertised /metrics addresses, silent)``
    for one inference job. ``silent`` counts the registered workers that
    advertise none (a thread worker's series live in its process's
    registry). A bus failure gives ``({}, 0)``, never an exception."""
    try:
        bus = services.serving_bus()
        prefix = f"w:{job_id}:"
        by_node: Dict[str, set] = {}
        silent = 0
        for k in bus.keys(prefix):
            info = bus.get(k) or {}
            addr = str(info.get("metrics") or "")
            if not addr:
                silent += 1
                continue
            node = str(info.get("node") or "")
            by_node.setdefault(node, set()).add(addr)
        return ({n: sorted(a) for n, a in sorted(by_node.items())},
                silent)
    except Exception:
        return ({}, 0)


def merge_worker_expositions(fetch, by_node: Dict[str, List[str]]
                             ) -> Tuple[str, int, int]:
    """Every advertised worker's exposition, concatenated: ``(text,
    fetched, failed)``. A failed fetch skips its worker and is
    counted."""
    parts: List[str] = []
    fetched = failed = 0
    for addrs in by_node.values():
        for addr in addrs:
            try:
                parts.append(fetch(addr, "/metrics"))
                fetched += 1
            except (OSError, ValueError):
                failed += 1
    return ("\n".join(parts), fetched, failed)


class ScrapeCache:
    """A per-sweep memo over ``fetch_endpoint``: a failure is memoised
    too and raised to each consumer, so a dead host costs one timeout a
    sweep. Built fresh each sweep, used on one thread."""

    def __init__(self, timeout: float = 5.0):
        self.timeout = timeout
        self._memo: Dict[Tuple[str, str], Tuple[bool, Any]] = {}

    def fetch(self, host: str, path: str) -> Any:
        key = (host, path)
        hit = self._memo.get(key)
        if hit is None:
            try:
                hit = (True, fetch_endpoint(host, path,
                                            timeout=self.timeout))
            except (OSError, ValueError) as e:
                hit = (False, e)
            self._memo[key] = hit
        ok, value = hit
        if not ok:
            raise value
        return value
