"""RTA2xx — thread lifecycle: every ``threading.Thread`` must be
daemonized or joined on some stop/close/drain path; every executor
must be shut down.

Historical bug this encodes: the ``_PersistStage``/micro-batcher/
write-behind pattern — each grew a background thread, and each
needed a review pass to guarantee the process can exit: a non-daemon,
never-joined thread wedges interpreter shutdown (the batcher review
caught exactly this before it shipped).

Rules:

RTA201: a ``threading.Thread(...)`` that is neither constructed with
``daemon=True`` (or later ``X.daemon = True``) nor ``.join()``-ed —
joins are looked up where the thread lands:

- assigned to ``self.X``: a ``self.X.join(...)`` anywhere in the class,
  including the ``for t in (self.A, self.B): t.join()`` loop idiom;
- assigned to a local: a ``X.join()`` in the same function;
- bare/module-level: any ``.join`` in the same scope.

RTA202: a ``concurrent.futures`` executor bound to ``self.X`` with no
``self.X.shutdown(...)`` in the class and never used as a context
manager.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..core import Checker, Finding, RepoContext, register

_EXECUTORS = {"ThreadPoolExecutor", "ProcessPoolExecutor"}


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _callee_name(call: ast.Call) -> str:
    """Last segment of the callee (``threading.Thread`` -> ``Thread``)."""
    f = call.func
    return f.attr if isinstance(f, ast.Attribute) else \
        (f.id if isinstance(f, ast.Name) else "")


def _has_daemon_kwarg(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    return False


def _joined_names(scope: ast.AST) -> Set[str]:
    """Names (locals and self-attrs, the latter as ``self.X``) that get
    a ``.join(...)`` call in ``scope``, including the loop-over-a-tuple
    idiom (``for t in (self.A, self.B): ... t.join()``)."""
    joined: Set[str] = set()
    loop_aliases: dict = {}
    for node in ast.walk(scope):
        if isinstance(node, ast.For) and \
                isinstance(node.target, ast.Name) and \
                isinstance(node.iter, (ast.Tuple, ast.List)):
            loop_aliases.setdefault(node.target.id, []).extend(
                node.iter.elts)
    for node in ast.walk(scope):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "join":
            obj = node.func.value
            attr = _self_attr(obj)
            if attr is not None:
                joined.add(f"self.{attr}")
            elif isinstance(obj, ast.Name):
                joined.add(obj.id)
                for el in loop_aliases.get(obj.id, []):
                    el_attr = _self_attr(el)
                    if el_attr is not None:
                        joined.add(f"self.{el_attr}")
                    elif isinstance(el, ast.Name):
                        joined.add(el.id)
    return joined


def _daemon_assigned(scope: ast.AST) -> Set[str]:
    """``X.daemon = True`` targets, as ``self.X`` or local names."""
    out: Set[str] = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        tgt.attr == "daemon":
                    owner = tgt.value
                    attr = _self_attr(owner)
                    if attr is not None:
                        out.add(f"self.{attr}")
                    elif isinstance(owner, ast.Name):
                        out.add(owner.id)
    return out


@register
class ThreadLifecycleChecker(Checker):
    name = "thread-lifecycle"
    codes = ("RTA201", "RTA202")

    def run(self, ctx: RepoContext) -> List[Finding]:
        findings: List[Finding] = []
        for mod in ctx.target_modules():
            if mod.tree is None:
                continue
            # Both codes need a call spelled Thread or an executor's
            # name: a module whose text has neither has no finding.
            if "Thread" not in mod.text and not any(
                    e in mod.text for e in _EXECUTORS):
                continue
            findings.extend(self._check_module(mod.rel, mod.tree))
        return findings

    def _check_module(self, rel: str, tree: ast.AST) -> List[Finding]:
        findings: List[Finding] = []
        # Pre-compute class-level facts.
        for cls in [n for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)]:
            joined = _joined_names(cls)
            daemons = _daemon_assigned(cls)
            shutdowns = {
                f"self.{_self_attr(n.func.value)}"
                for n in ast.walk(cls)
                if isinstance(n, ast.Call) and
                isinstance(n.func, ast.Attribute) and
                n.func.attr == "shutdown" and
                _self_attr(n.func.value) is not None}
            for meth in [n for n in cls.body
                         if isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))]:
                local_joined = _joined_names(meth)
                local_daemons = _daemon_assigned(meth)
                for stmt in ast.walk(meth):
                    if not isinstance(stmt, ast.Assign):
                        continue
                    call = stmt.value
                    if not isinstance(call, ast.Call):
                        continue
                    name = _callee_name(call)
                    target = self._single_target(stmt)
                    if name == "Thread":
                        if _has_daemon_kwarg(call):
                            continue
                        ok = (target is not None and
                              (target in joined or target in daemons or
                               target in local_joined or
                               target in local_daemons))
                        if not ok:
                            findings.append(self._thread_finding(
                                rel, cls.name, meth.name, call, target))
                    elif name in _EXECUTORS:
                        if target is None or not \
                                target.startswith("self."):
                            continue
                        if target not in shutdowns:
                            findings.append(Finding(
                                code="RTA202", path=rel,
                                line=call.lineno,
                                message=f"{cls.name}.{meth.name}() "
                                        f"creates {name} {target} but "
                                        f"the class never calls "
                                        f"{target}.shutdown()",
                                hint="add shutdown(wait=True) to the "
                                     "class's close/stop path",
                                anchor=f"{cls.name}.{target}:executor"))
        # Module-level / free-function threads.
        findings.extend(self._check_free_threads(rel, tree))
        return findings

    @staticmethod
    def _single_target(stmt: ast.Assign) -> Optional[str]:
        if len(stmt.targets) != 1:
            return None
        tgt = stmt.targets[0]
        attr = _self_attr(tgt)
        if attr is not None:
            return f"self.{attr}"
        if isinstance(tgt, ast.Name):
            return tgt.id
        return None

    def _thread_finding(self, rel, cls_name, meth_name, call,
                        target) -> Finding:
        where = f"{cls_name}.{meth_name}()" if cls_name else \
            (f"{meth_name}()" if meth_name else "module level")
        tgt = target or "<unnamed>"
        return Finding(
            code="RTA201", path=rel, line=call.lineno,
            message=f"{where} starts a Thread ({tgt}) that is neither "
                    f"daemon=True nor joined on any stop/close path",
            hint="pass daemon=True, or join it from stop()/close()/"
                 "drain() so process exit cannot wedge",
            anchor=f"{cls_name or meth_name or '<module>'}.{tgt}:thread")

    def _check_free_threads(self, rel: str,
                            tree: ast.AST) -> List[Finding]:
        findings: List[Finding] = []
        class_nodes = {id(n) for c in ast.walk(tree)
                       if isinstance(c, ast.ClassDef)
                       for n in ast.walk(c)}
        funcs = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef,
                                   ast.AsyncFunctionDef))
                 and id(n) not in class_nodes]
        func_inner = {id(n) for f in funcs for n in ast.walk(f)}
        for scope, scope_name in [(tree, "")] + \
                [(f, f.name) for f in funcs]:
            joined = _joined_names(scope)
            daemons = _daemon_assigned(scope)
            if scope is tree:
                # Whole-module walk minus class bodies (handled by
                # _check_module) and function interiors (their own
                # scope entries below): a Thread built under an if/
                # try/with block is still module-level.
                stmts = [n for n in ast.walk(tree)
                         if id(n) not in class_nodes
                         and id(n) not in func_inner]
            else:
                stmts = list(ast.walk(scope))
            for stmt in stmts:
                if isinstance(stmt, ast.Assign) and \
                        isinstance(stmt.value, ast.Call) and \
                        _callee_name(stmt.value) == "Thread" and \
                        id(stmt) not in class_nodes:
                    if _has_daemon_kwarg(stmt.value):
                        continue
                    target = self._single_target(stmt)
                    if target is not None and (target in joined or
                                               target in daemons):
                        continue
                    findings.append(self._thread_finding(
                        rel, "", scope_name, stmt.value, target))
        return findings
