"""Static analysis of the port's own tree: machine-checked
concurrency, resource-lifecycle, aliasing and drift invariants as
tier-1 gates.

The counterpart of ``rafiki_tpu.analysis``, with its codes, anchors,
waiver syntax, baseline format and CLI. It analyses ``rafiki_torch/``
(plus the shared ``docs/`` and the port's ``web/`` pages). Every
checker encodes a bug class the reference shipped and found by hand,
or, for RTA4xx, the port's own:

- **RTA1xx guarded-state** — the ParamStore write-behind
  row-before-file race was a cross-thread invariant nobody's eyes
  caught until a cross-process reader crashed. The checker infers each
  class's lock-guarded attribute set from ``with self._lock:`` bodies
  and flags accesses outside any guarding lock, blocking calls made
  while holding a lock, and lock-order cycles.
- **RTA2xx thread-lifecycle** — the ``_PersistStage``/batcher/
  write-behind pattern: every ``threading.Thread`` must be daemonized
  or joined on some stop/close/drain path, every executor shut down.
- **RTA3xx series-lifecycle** — the leaked per-trial/per-instance
  metric series: dynamically-labeled series need a matching
  ``.remove(...)`` in the same module.
- **RTA4xx aliasing** — F7, the staged-dataset hazard: a tensor a
  cache holds must never be written in place or be a view
  (``torch.from_numpy``) of a cached host array, and a method that
  replays a CUDA graph must not hand out the graph's static output
  itself. (The reference's RTA4xx is jax buffer donation, which the
  port does not have.)
- **RTA5xx drift** — metric naming, dashboard references, knob
  documentation, and every ``RAFIKI_TPU_*`` env literal read anywhere
  must be a NodeConfig field with ``apply_env`` parity. The port keeps
  the reference's series and knob names, so the prefixes stay
  ``rafiki_tpu_`` and ``RAFIKI_TPU_``.
- **RTA6xx import hygiene** — import-time side effects, and an eager
  ``torch``/``triton`` import on the bus/broker path.
- **RTA7xx flow** — bus queue families, HTTP routes, and the cluster
  fabric's off-path promise.

Stdlib-only (``ast``, ``tokenize``, ``json``, ``fnmatch``, and
``subprocess`` for git in ``--changed``/``--diff``; no torch, numpy or
``rafiki_tpu`` import, and it touches no device — the suite runs
wherever Python does). Entry points:

    python -m rafiki_torch.analysis [--changed] [--json] [--update-baseline]

and programmatically :func:`run_suite`. Pre-existing findings are
frozen in ``baseline.json`` next to this package (each with a reason);
CI enforces **zero new findings**. One-off accepted findings are
waived inline: ``# rta: disable=RTA101 <reason>`` (reason required).

``docs/analysis.md`` describes the reference's suite: the same catalog
and waiver/baseline policy, but for RTA4xx and RTA602.
``--explain CODE`` prints the port's catalog entry.
"""

from .core import (  # noqa: F401
    Checker,
    Finding,
    RepoContext,
    all_checkers,
    baseline_path,
    load_baseline,
    register,
    run_suite,
)

__all__ = ["Checker", "Finding", "RepoContext", "all_checkers",
           "baseline_path", "load_baseline", "register", "run_suite"]
