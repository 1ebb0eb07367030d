"""RTA3xx — metric series lifecycle: dynamically-labeled series need a
matching ``.remove(...)`` in the same module.

Historical bug this encodes: the review found every per-trial MFU /
step-time series and every per-instance serving/http series living
forever in the process registry — a long-lived resident runner that
deploys/stops predictors or cycles trials grew the registry (and every
``/metrics`` scrape payload) without bound. The fix added
``Counter/Gauge/Histogram.remove(**label_subset)`` and a ``.remove``
call on each owner's stop/close/trial-end path; this checker keeps
that contract mechanical.

Rule: a module that records metric samples with a **dynamic label** —
a keyword argument to ``.inc()``/``.dec()``/``.set()``/``.observe()``
whose value is not a literal, a ``**labels`` splat, or a
``label_context(label=<dynamic>)`` binding — must also contain a
``.remove(...)`` mentioning that label name (or a ``.remove(**...)``).
A dynamic label means unbounded series churn; the remove is the only
thing that lets them die.

Deliberately-immortal bounded-vocabulary labels (``phase=``, ``kind=``,
``event=`` drawn from fixed tuples) are the documented false-positive
class: waive them inline with the vocabulary as the reason.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..core import Checker, Finding, RepoContext, register

_SAMPLE_METHODS = {"inc", "dec", "set", "observe"}


def _is_metrics_module(text: str) -> bool:
    """Cheap scope filter: only modules that touch the metrics plane.

    Keeps ``.set(...)`` calls on unrelated objects in non-metrics
    modules out of scope entirely.
    """
    return ("rafiki_tpu_" in text and
            ("metrics" in text or "registry" in text)) or \
        "label_context" in text


@register
class SeriesLifecycleChecker(Checker):
    name = "series-lifecycle"
    codes = ("RTA301",)

    def run(self, ctx: RepoContext) -> List[Finding]:
        findings: List[Finding] = []
        for mod in ctx.target_modules():
            if mod.tree is None or not _is_metrics_module(mod.text):
                continue
            findings.extend(self._check_module(mod.rel, mod.tree))
        return findings

    def _check_module(self, rel: str, tree: ast.AST) -> List[Finding]:
        dynamic: Dict[str, Tuple[int, str]] = {}  # label -> (line, via)
        removed_labels = set()
        has_splat_remove = False

        calls = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and \
                    func.attr == "remove":
                if not node.keywords and not node.args:
                    # A bare .remove() matches the EMPTY label subset —
                    # it deletes every series of that metric (the attribution
                    # ledger's close-last-owner path), so it covers any
                    # dynamic label in the module. Positional-arg
                    # removes are NOT this: `os.remove(path)` and
                    # `list.remove(x)` in a metrics module must never
                    # silently disable the checker.
                    has_splat_remove = True
                for kw in node.keywords:
                    if kw.arg is None:
                        has_splat_remove = True
                    else:
                        removed_labels.add(kw.arg)
                continue
            label_kws = self._dynamic_label_kwargs(node)
            if label_kws:
                all_labels = {kw.arg for kw in node.keywords
                              if kw.arg is not None}
                calls.append((node, label_kws, all_labels))
        for node, label_kws, all_labels in calls:
            # ``remove(service=...)`` matches by label SUBSET, so it
            # kills every series of a sample that also carried a
            # stage=/reason= label — one removed co-label covers the
            # whole call.
            if all_labels & removed_labels:
                continue
            for label, via in label_kws:
                dynamic.setdefault(label, (node.lineno, via))

        findings = []
        for label, (line, via) in sorted(dynamic.items()):
            if label in removed_labels or has_splat_remove:
                continue
            shown = label if label != "**" else "**<labels>"
            findings.append(Finding(
                code="RTA301", path=rel, line=line,
                message=f"metric series get a dynamic "
                        f"{shown!r} label (via {via}) but this module "
                        f"never calls .remove({'' if label == '**' else label + '=...'}"
                        f"{'**...' if label == '**' else ''}) — series "
                        f"leak across instance/trial churn",
                hint="call <metric>.remove(%s=<value>) from the owner's "
                     "stop/close/trial-end path, or waive with the "
                     "bounded label vocabulary as the reason"
                     % (label if label != "**" else "label"),
                anchor=f"label:{label}"))
        return findings

    def _dynamic_label_kwargs(
            self, call: ast.Call) -> List[Tuple[str, str]]:
        """Dynamic labels this call binds: from a sample method
        (``.inc/.dec/.set/.observe``) or a ``label_context(...)``."""
        func = call.func
        via: Optional[str] = None
        if isinstance(func, ast.Attribute) and \
                func.attr in _SAMPLE_METHODS:
            via = f".{func.attr}()"
        elif (isinstance(func, ast.Attribute) and
              func.attr == "label_context") or \
                (isinstance(func, ast.Name) and
                 func.id == "label_context"):
            via = "label_context()"
        if via is None:
            return []
        out: List[Tuple[str, str]] = []
        for kw in call.keywords:
            if kw.arg is None:
                out.append(("**", via))
            elif not isinstance(kw.value, ast.Constant):
                out.append((kw.arg, via))
        return out
