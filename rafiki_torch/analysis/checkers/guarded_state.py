"""RTA1xx — guarded-state: infer each class's lock-guarded attribute
set and flag accesses that bypass it, blocking calls made while a lock
is held, and lock-order cycles.

Historical bugs this encodes (docs/analysis.md):

- the ParamStore write-behind row-before-file race: ``_pending``
  had to be re-checked under ``_pending_lock`` atomically with the
  index insert — a hand-found cross-thread ordering bug of exactly the
  shape RTA101 mechanizes;
- the micro-batcher's stop()-vs-submit races: every admission
  field moved under ``_cond`` after review.

Inference (per class):

1. **Lock attributes**: ``self.X = threading.Lock()/RLock()/
   Condition()``. ``Event``/``Semaphore``/``queue.Queue`` etc. are
   *atomic* primitives — excluded from the guarded set (their methods
   synchronize internally).
2. **State attributes**: assigned outside ``__init__`` anywhere in the
   class, or mutated through a container method (``append``/``pop``/
   ``update``/...). Attributes bound once in ``__init__`` and only
   read afterwards (collaborators, config) are not state.
3. **Guarded set**: state attributes accessed at least once while a
   lock is held. The guard is the union of locks ever held at an
   access, so multi-lock classes (queue under ``_cond``, completions
   under ``_completions_cond``) resolve per attribute.
4. A **private method whose every intra-class call site holds lock L**
   is analyzed as if it held L (the ``_drain_into`` "caller holds
   _cond" pattern), to a fixpoint. Closures/nested defs run later and
   inherit nothing.

The per-class walk itself lives in ``analysis.program``: one
classify+walk per class per run, shared with the interprocedural
RTA104-106 checker through ``ctx.program()``.

RTA101: guarded attribute accessed while holding none of its guards
(outside ``__init__``).
RTA102: blocking call (sleep, subprocess, socket, ``open``, thread
``join``, future ``result``, non-lock ``wait``, queue ``get``/``put``)
made while holding a lock — *directly in the method*; the call-chain
form is RTA105 (checkers/concurrency.py).
RTA103: lock-order cycle across the class's intra-class call graph
(including a self-cycle on a non-reentrant ``Lock``); the cross-class
form is RTA104.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from ..core import Checker, Finding, RepoContext, register
from ..program import (_Access, _blocking_label, _ClassInfo, _self_attr,
                       held_display)


@register
class GuardedStateChecker(Checker):
    name = "guarded-state"
    codes = ("RTA101", "RTA102", "RTA103")

    def run(self, ctx: RepoContext) -> List[Finding]:
        findings: List[Finding] = []
        program = ctx.program()
        for mod in ctx.target_modules():
            if mod.tree is None:
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    cls = program.class_info(node)
                    if not cls.lock_attrs:
                        continue
                    findings.extend(self._check_class(mod.rel, cls))
            findings.extend(self._module_unguarded(mod.rel, program))
        return findings

    def _check_class(self, rel: str, cls: _ClassInfo) -> List[Finding]:
        extra = cls.held_extra()
        findings: List[Finding] = []
        findings.extend(self._unguarded(rel, cls, extra))
        findings.extend(self._blocking(rel, cls, extra))
        findings.extend(self._lock_order(rel, cls, extra))
        return findings

    # --- RTA101 ---

    def _unguarded(self, rel: str, cls: _ClassInfo,
                   extra: Dict[str, frozenset]) -> List[Finding]:
        def effective(acc: _Access) -> frozenset:
            if acc.nested:
                return acc.held  # closures run later, inherit nothing
            return acc.held | extra.get(acc.method, frozenset())

        candidates = (cls.state_attrs - cls.lock_attrs
                      - cls.atomic_attrs)
        guards: Dict[str, Set[str]] = {}
        for acc in cls.accesses:
            if acc.attr in candidates:
                guards.setdefault(acc.attr, set()).update(effective(acc))

        findings = []
        seen: Set[Tuple[str, str]] = set()
        for acc in cls.accesses:
            g = guards.get(acc.attr)
            if not g or acc.method == "__init__":
                continue
            if effective(acc) & g:
                continue
            key = (acc.attr, acc.method)
            if key in seen:
                continue
            seen.add(key)
            lock_list = "/".join(held_display(x) for x in sorted(g))
            findings.append(Finding(
                code="RTA101", path=rel, line=acc.line,
                message=f"{cls.name}.{acc.attr} is guarded by "
                        f"{lock_list} elsewhere but "
                        f"{'written' if acc.is_write else 'read'} in "
                        f"{acc.method}() without holding it",
                hint=f"wrap the access in `with {lock_list.split('/')[0]}:` "
                     f"or waive with the reason the race is benign",
                anchor=f"{cls.name}.{acc.attr}@{acc.method}"))
        return findings

    # --- RTA101, module-global form ---

    def _module_unguarded(self, rel: str, program) -> List[Finding]:
        """Free functions sharing module globals under module-global
        locks (the observe/* registry shape): a global guarded by
        ``with _lock:`` at some accesses but touched bare elsewhere is
        the same race RTA101 flags on classes. Guards are inferred the
        same way — the union of module locks ever held at an access —
        so consistently-bare globals (no lock discipline at all) never
        flag; the module equivalent of an unlocked class is out of
        scope by design."""
        ms = program.module_state(rel)
        if not ms.accesses:
            return []
        guards: Dict[str, Set[str]] = {}
        for name, held, _func, _line, _w in ms.accesses:
            guards.setdefault(name, set()).update(held)
        findings: List[Finding] = []
        seen: Set[Tuple[str, str]] = set()
        stem = rel.rsplit("/", 1)[-1][:-3]
        for name, held, func, line, is_write in ms.accesses:
            g = guards.get(name)
            if not g or held & g:
                continue
            key = (name, func)
            if key in seen:
                continue
            seen.add(key)
            lock_list = "/".join(sorted(g))
            findings.append(Finding(
                code="RTA101", path=rel, line=line,
                message=f"module global {name} is guarded by "
                        f"{lock_list} elsewhere but "
                        f"{'written' if is_write else 'read'} in "
                        f"{func}() without holding it",
                hint=f"wrap the access in `with "
                     f"{lock_list.split('/')[0].rsplit('.', 1)[-1]}:` "
                     f"or waive with the reason the race is benign",
                anchor=f"{stem}:{name}@{func}"))
        return findings

    # --- RTA102 ---

    def _blocking(self, rel: str, cls: _ClassInfo,
                  extra: Dict[str, frozenset]) -> List[Finding]:
        findings = []
        seen: Set[str] = set()
        for call, held, method, depth, _fns in cls.calls:
            eff = held if depth > 0 else \
                held | extra.get(method, frozenset())
            if not eff:
                continue
            label = _blocking_label(cls, call)
            if label is None:
                continue
            anchor = f"{cls.name}.{method}:{label}"
            if anchor in seen:
                continue
            seen.add(anchor)
            locks = "/".join(held_display(x) for x in sorted(eff))
            findings.append(Finding(
                code="RTA102", path=rel, line=call.lineno,
                message=f"{cls.name}.{method}() calls blocking "
                        f"{label} while holding {locks}",
                hint="move the blocking call outside the lock (snapshot "
                     "state under the lock, act on it after release)",
                anchor=anchor))
        return findings

    # --- RTA103 ---

    def _lock_order(self, rel: str, cls: _ClassInfo,
                    extra: Dict[str, frozenset]) -> List[Finding]:
        acq = cls.acquired()
        edges: Dict[Tuple[str, str], Tuple[int, str]] = {}

        def add_edge(a: str, b: str, line: int, method: str) -> None:
            edges.setdefault((a, b), (line, method))

        for held, lock, line, method, depth in cls.lock_entries:
            eff = held if depth > 0 else \
                held | extra.get(method, frozenset())
            for outer in eff:
                add_edge(outer, lock, line, method)
        for call, held, method, depth, _fns in cls.calls:
            eff = held if depth > 0 else \
                held | extra.get(method, frozenset())
            if not eff:
                continue
            callee = _self_attr(call.func)
            if callee:
                for inner in acq.get(callee, ()):  # locks the callee takes
                    for outer in eff:
                        add_edge(outer, inner, call.lineno, method)

        findings = []
        # Self-edge on a non-reentrant Lock is an immediate deadlock.
        for (a, b), (line, method) in sorted(edges.items()):
            if a == b and cls.lock_kind.get(a) == "Lock":
                findings.append(Finding(
                    code="RTA103", path=rel, line=line,
                    message=f"{cls.name}.{method}() re-acquires "
                            f"non-reentrant self.{a} while holding it "
                            f"(guaranteed deadlock)",
                    hint="use threading.RLock, or restructure so the "
                         "inner path is called lock-free",
                    anchor=f"{cls.name}:{a}->{a}"))
        # Two-lock cycles (A->B and B->A); deeper cycles reduce to one
        # of these in practice for intra-class locking.
        for (a, b), (line, method) in sorted(edges.items()):
            if a < b and (b, a) in edges:
                findings.append(Finding(
                    code="RTA103", path=rel, line=line,
                    message=f"{cls.name}: lock-order cycle self.{a} -> "
                            f"self.{b} (in {method}) vs self.{b} -> "
                            f"self.{a} (in {edges[(b, a)][1]})",
                    hint="pick one acquisition order and restructure "
                         "the other path to follow it",
                    anchor=f"{cls.name}:{a}<->{b}"))
        return findings
