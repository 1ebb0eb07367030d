"""RTA4xx — torch aliasing vs cached and graph-owned tensors.

The port has no buffer donation (``donate_argnums`` is jax's). Its
hazard of the same class is an ALIAS: a tensor that shares memory with
something a cache or a CUDA graph owns, written through or read after
the owner has moved on.

Historical bug this encodes: F7 (ROADMAP queue 3). The host dataset
cache hands every trial the same read-only numpy arrays, and the device
staging cache keeps a set's tensors resident across trials. On the CPU
``torch.from_numpy(ds.images).to(device)`` is the cached array's own
memory, so a write to the staged tensor would change every later
trial's data under an unchanged fingerprint. The staging cache copies
(``torch.tensor``); this checker makes that invariant mechanical.

Mechanics (module-scope, two-level dataflow — no execution), as the
reference's donation checker:

- **Cache-tainted values**: names assigned (possibly through tuple
  unpacking) from a call whose name mentions ``stage``/``cache``, or
  from a subscript/attribute of a ``*_CACHE`` global; plain ``a = b``
  aliases and view-returning methods (``view``, ``reshape``, ``to``,
  ...) carry the taint.
- **Taint through helper returns**: a module function whose RETURN
  expression is cache-tainted taints its call sites by name — a
  neutral-named wrapper (``def fetch_resident(): return
  _STAGE_CACHE[k]``) poisons exactly like the direct read. Fixpoint
  over the module's defs, so helper-calls-helper chains resolve.
- **Cache-bound values**: the arguments of a call whose name mentions
  ``stage``/``cache`` (lambdas among them: ``_staged(..., lambda:
  ...)`` makes the entry the cache keeps), and the value stored into a
  ``*_CACHE`` global's subscript.

RTA401: a cache-tainted value is written in place (a method ending in
``_`` such as ``copy_``, ``add_`` or ``zero_``, an ``out=`` argument, a
subscript store, an augmented assignment), or a cache-tainted or
cache-bound value is made by ``torch.from_numpy`` / ``torch.as_tensor``
/ ``torch.asarray`` / ``torch.frombuffer``, which alias their input,
instead of being copied.
RTA402: a method that replays a CUDA graph returns or stores the
graph's static output itself rather than a copy (``.clone()``): the
next replay overwrites it under the caller. A static output is an
attribute assigned inside a ``with graph_capture(...)`` /
``torch.cuda.graph(...)`` block, directly or through a local that was.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ..core import Checker, Finding, RepoContext, register

_CACHE_CALL_RE = re.compile(r"stage|cache", re.IGNORECASE)
_CACHE_GLOBAL_RE = re.compile(r"_CACHE\b")

#: Constructors that share memory with their input.
_ALIASING_CTORS = {"from_numpy", "as_tensor", "asarray", "frombuffer"}
#: Methods whose result may share memory with the receiver (``to`` and
#: ``contiguous`` return the receiver itself when nothing changes).
_VIEW_METHODS = {"view", "view_as", "reshape", "reshape_as", "flatten",
                 "unflatten", "transpose", "permute", "movedim", "narrow",
                 "select", "expand", "expand_as", "squeeze", "unsqueeze",
                 "t", "detach", "diagonal", "as_strided", "unbind",
                 "split", "chunk", "to", "contiguous", "cpu", "cuda",
                 "numpy", "get"}
#: In-place methods end in ``_``; these do not write their receiver.
_NOT_WRITES = {"requires_grad_", "share_memory_"}
#: Context managers under which a CUDA graph is captured.
_CAPTURE_CMS = {"graph_capture", "graph"}


def _last_name(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _label(node: ast.AST) -> str:
    return ast.unparse(node)


class _Scope:
    """One function body (or the module body): the taint of its names,
    line by line. ``tainted_fns`` are module helpers whose returns are
    cache-tainted (see ``_return_tainted_fns``) — calls to them taint
    like direct cache reads."""

    def __init__(self, node, name: str,
                 tainted_fns: frozenset = frozenset()):
        self.node = node
        self.name = name
        self.tainted_fns = tainted_fns
        #: name -> [(line, tainted)] of its binds, in line order: a
        #: rebind to a copy (``x = x.clone()``) ends the taint.
        self.binds: Dict[str, List[Tuple[int, bool]]] = {}
        self._nodes: Optional[List[ast.AST]] = None
        self._assigns: List[ast.AST] = []

    def own_nodes(self) -> List[ast.AST]:
        """Every node of this scope's own body: nested function bodies
        are their own scopes; lambdas stay (they see this scope's
        names)."""
        if self._nodes is None:
            out: List[ast.AST] = []
            stack = list(self.node.body)
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                out.append(node)
                stack.extend(ast.iter_child_nodes(node))
            self._nodes = out
            self._assigns = sorted(
                (n for n in out
                 if isinstance(n, (ast.Assign, ast.AnnAssign))),
                key=lambda n: (n.lineno, n.col_offset))
        return self._nodes

    def analyze(self, tainted_fns: Optional[frozenset] = None) -> None:
        """Walk the binds in line order (no loop back-edges)."""
        if tainted_fns is not None:
            self.tainted_fns = tainted_fns
        self.binds = {}
        self.own_nodes()
        for node in self._assigns:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    self._bind(tgt, node.value, node.lineno)
            elif node.value is not None:
                self._bind(node.target, node.value, node.lineno)

    def _bind(self, tgt: ast.AST, value: ast.AST, line: int) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            values = value.elts if isinstance(
                value, (ast.Tuple, ast.List)) and \
                len(value.elts) == len(tgt.elts) else \
                [value] * len(tgt.elts)
            for el, v in zip(tgt.elts, values):
                self._bind(el, v, line)
            return
        if isinstance(tgt, ast.Name):
            self.binds.setdefault(tgt.id, []).append(
                (line, self.is_tainted(value)))

    def _name_tainted(self, name: ast.Name) -> bool:
        state = False
        for line, tainted in self.binds.get(name.id, ()):
            if line >= name.lineno:
                break
            state = tainted
        return state

    def is_tainted(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return self._name_tainted(expr) or _expr_tainted(
                expr, self.tainted_fns)
        if isinstance(expr, ast.Call) and \
                isinstance(expr.func, ast.Attribute) and \
                expr.func.attr in _VIEW_METHODS and \
                self.is_tainted(expr.func.value):
            return True
        if _expr_tainted(expr, self.tainted_fns):
            return True
        if isinstance(expr, ast.Attribute):
            return self.is_tainted(expr.value)
        if isinstance(expr, ast.Subscript):
            # Basic indexing is a view; a tensor or list index gathers
            # into a new tensor.
            return _basic_index(expr.slice) and \
                self.is_tainted(expr.value)
        return False


def _basic_index(node: ast.AST) -> bool:
    if isinstance(node, ast.Tuple):
        return all(_basic_index(el) for el in node.elts)
    return isinstance(node, (ast.Constant, ast.Slice, ast.Name)) or (
        isinstance(node, ast.UnaryOp)
        and isinstance(node.operand, ast.Constant))


def _expr_tainted(value: ast.AST,
                  tainted_fns: frozenset = frozenset()) -> bool:
    """Does this RHS pull from a staging/residency cache — directly,
    or through a helper whose return is tainted (``tainted_fns``)?"""
    if isinstance(value, ast.Call):
        name = _last_name(value.func)
        if _CACHE_CALL_RE.search(name) or name in tainted_fns:
            return True
        # one level deep: _STAGE_CACHE.get(...)
        if isinstance(value.func, ast.Attribute):
            return _expr_tainted(value.func.value, tainted_fns)
        return False
    if isinstance(value, ast.Subscript) or isinstance(value,
                                                      ast.Attribute):
        return _expr_tainted(value.value, tainted_fns)
    if isinstance(value, ast.Name):
        return bool(_CACHE_GLOBAL_RE.search(value.id))
    return False


def _own_returns(fn) -> List[ast.AST]:
    """``return`` expressions of ``fn``'s OWN body (nested defs are
    their own scopes and must not leak their returns up)."""
    out: List[ast.AST] = []
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            out.append(node.value)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _return_tainted_fns(scopes: List[_Scope]) -> frozenset:
    """Names of the functions (``scopes``) whose return value is
    cache-tainted. Iterates to a TRUE fixpoint (a fixed round count
    would silently miss depth-3+ helper chains in adversarial
    definition order); each round can only grow the set, so it
    terminates within len(fns) rounds. Matching at call sites is by
    LAST name (methods included)."""
    returns = {id(sc): _own_returns(sc.node) for sc in scopes}
    tainted: set = set()
    changed = True
    while changed:
        changed = False
        for scope in scopes:
            if scope.name in tainted or not returns[id(scope)]:
                continue
            scope.analyze(frozenset(tainted))

            def ret_tainted(expr: ast.AST) -> bool:
                if isinstance(expr, ast.Tuple):
                    return any(ret_tainted(el) for el in expr.elts)
                return scope.is_tainted(expr)

            if any(ret_tainted(r) for r in returns[id(scope)]):
                tainted.add(scope.name)
                changed = True
    return frozenset(tainted)


def _is_cache_global(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and \
        bool(_CACHE_GLOBAL_RE.search(node.id))


def _is_aliasing_ctor(call: ast.Call) -> bool:
    return _last_name(call.func) in _ALIASING_CTORS and \
        isinstance(call.func, ast.Attribute) and \
        _last_name(call.func.value) == "torch"


@register
class AliasingChecker(Checker):
    name = "aliasing"
    codes = ("RTA401", "RTA402")

    def run(self, ctx: RepoContext) -> List[Finding]:
        findings: List[Finding] = []
        for mod in ctx.target_modules():
            if mod.tree is None:
                continue
            # Taint starts only at a stage/cache-named call or a
            # *_CACHE global: a module that names neither has none.
            if _CACHE_CALL_RE.search(mod.text):
                findings.extend(self._check_writes(mod.rel, mod.tree))
            if ".replay(" in mod.text:
                findings.extend(self._check_replays(mod.rel, mod.tree))
        return findings

    # --- RTA401 ---

    def _check_writes(self, rel: str, tree: ast.AST) -> List[Finding]:
        fns = [_Scope(node, node.name) for node in ast.walk(tree)
               if isinstance(node, (ast.FunctionDef,
                                    ast.AsyncFunctionDef))]
        ret_tainted = _return_tainted_fns(fns)
        scopes = [_Scope(tree, "<module>")] + fns
        findings: List[Finding] = []
        seen: Set[str] = set()

        def emit(scope: _Scope, node: ast.AST, kind: str, label: str,
                 message: str, hint: str) -> None:
            anchor = f"{scope.name}:{kind}:{label}"
            if anchor in seen:
                return
            seen.add(anchor)
            findings.append(Finding(
                code="RTA401", path=rel, line=node.lineno,
                message=message, hint=hint, anchor=anchor))

        write_hint = ("write into a copy (``x = x.clone()``) or into a "
                      "tensor the cache does not hold; a cached entry "
                      "is shared by every later trial")
        alias_hint = ("copy into the cache (``torch.tensor(a, "
                      "device=...)``); a cached tensor must never be a "
                      "view of a host array, which on the CPU the "
                      "tensor IS")
        for scope in scopes:
            scope.analyze(ret_tainted)
            bound = self._cache_bound(scope)
            for node in scope.own_nodes():
                if isinstance(node, ast.Call):
                    func = node.func
                    if isinstance(func, ast.Attribute) and \
                            func.attr.endswith("_") and \
                            not func.attr.endswith("__") and \
                            func.attr not in _NOT_WRITES and \
                            scope.is_tainted(func.value):
                        label = _label(func.value)
                        emit(scope, node, func.attr, label,
                             f"{label!r} comes from a staging/residency "
                             f"cache and is written in place by "
                             f".{func.attr}() — every later consumer "
                             f"of the entry sees the write", write_hint)
                    for kw in node.keywords:
                        if kw.arg == "out" and scope.is_tainted(kw.value):
                            label = _label(kw.value)
                            emit(scope, node, "out", label,
                                 f"{label!r} comes from a staging/"
                                 f"residency cache and is the out= of "
                                 f"{_last_name(func)}()", write_hint)
                    if _is_aliasing_ctor(node) and node.args and (
                            scope.is_tainted(node.args[0])
                            or id(node) in bound):
                        label = _label(node.args[0])
                        ctor = _last_name(func)
                        emit(scope, node, ctor, label,
                             f"torch.{ctor}({label}) shares memory with "
                             f"its input, and the tensor is a cache's "
                             f"entry or is made from one — a write to "
                             f"either side changes the other",
                             alias_hint)
                elif isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = node.targets if isinstance(
                        node, ast.Assign) else [node.target]
                    for tgt in targets:
                        inplace = isinstance(node, ast.AugAssign) and \
                            isinstance(tgt, ast.Name)
                        if isinstance(tgt, ast.Subscript) and \
                                _is_cache_global(tgt.value):
                            continue    # a slot of the cache itself
                        if (isinstance(tgt, ast.Subscript) or inplace) \
                                and scope.is_tainted(
                                    tgt if inplace else tgt.value):
                            label = _label(tgt if inplace else tgt.value)
                            emit(scope, node, "store", label,
                                 f"{label!r} comes from a staging/"
                                 f"residency cache and is written here "
                                 f"— every later consumer of the entry "
                                 f"sees the write", write_hint)
        return findings

    @staticmethod
    def _cache_bound(scope: _Scope) -> Set[int]:
        """ids of the nodes whose value goes INTO a cache: the arguments
        of a stage/cache-named call (lambda bodies included) and the
        value of a store into a ``*_CACHE`` global's subscript."""
        out: Set[int] = set()
        for node in scope.own_nodes():
            roots: List[ast.AST] = []
            if isinstance(node, ast.Call) and \
                    _CACHE_CALL_RE.search(_last_name(node.func)):
                roots = list(node.args) + [kw.value
                                           for kw in node.keywords]
            elif isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Subscript)
                    and _is_cache_global(t.value) for t in node.targets):
                roots = [node.value]
            for root in roots:
                for sub in ast.walk(root):
                    out.add(id(sub))
        return out

    # --- RTA402 ---

    def _check_replays(self, rel: str, tree: ast.AST) -> List[Finding]:
        findings: List[Finding] = []
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            static = self._static_attrs(methods)
            if not static:
                continue
            for fn in methods:
                if not any(isinstance(n, ast.Call)
                           and _last_name(n.func) == "replay"
                           for n in ast.walk(fn)):
                    continue
                findings.extend(self._judge_replay(rel, cls.name, fn,
                                                   static))
        return findings

    @staticmethod
    def _static_attrs(methods) -> Set[str]:
        """``self`` attributes that hold a captured graph's outputs."""
        static: Set[str] = set()
        for fn in methods:
            captured: Set[str] = set()    # locals bound in a capture
            for node in ast.walk(fn):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                if not any(isinstance(it.context_expr, ast.Call)
                           and _last_name(it.context_expr.func)
                           in _CAPTURE_CMS for it in node.items):
                    continue
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign):
                        for tgt in sub.targets:
                            for el in _flat(tgt):
                                if _self_attr(el):
                                    static.add(_self_attr(el))
                                elif isinstance(el, ast.Name):
                                    captured.add(el.id)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    for el, val in _pairs(tgt, node.value):
                        if _self_attr(el) and isinstance(val, ast.Name) \
                                and val.id in captured:
                            static.add(_self_attr(el))
        return static

    @staticmethod
    def _judge_replay(rel: str, cls: str, fn, static: Set[str]
                      ) -> List[Finding]:
        findings: List[Finding] = []
        local: Set[str] = set()   # locals bound to a static output

        def bare(expr: ast.AST) -> Optional[str]:
            for el in _flat(expr):
                attr = _self_attr(el)
                if attr in static:
                    return f"self.{attr}"
                if isinstance(el, ast.Name) and el.id in local:
                    return el.id
            return None

        def emit(node: ast.AST, what: str, how: str) -> None:
            findings.append(Finding(
                code="RTA402", path=rel, line=node.lineno,
                message=f"{cls}.{fn.name}() replays a CUDA graph and "
                        f"{how} {what}, the graph's static output "
                        f"itself — the next replay overwrites it",
                hint="return or keep a copy (``.clone()``), or waive "
                     "with why every reader is done before the next "
                     "replay",
                anchor=f"{cls}.{fn.name}:{what}"))

        for node in sorted((n for n in ast.walk(fn)
                            if isinstance(n, (ast.Return, ast.Assign,
                                              ast.Call))),
                           key=lambda n: (n.lineno, n.col_offset)):
            if isinstance(node, ast.Return) and node.value is not None:
                what = bare(node.value)
                if what:
                    emit(node, what, "returns")
            elif isinstance(node, ast.Assign):
                what = bare(node.value)
                if what is None:
                    continue
                for tgt in node.targets:
                    for el in _flat(tgt):
                        if isinstance(el, ast.Name):
                            local.add(el.id)
                        else:
                            emit(node, what, "stores")
            elif isinstance(node, ast.Call) and \
                    _last_name(node.func) in ("append", "put", "extend",
                                              "setdefault"):
                for arg in node.args:
                    what = bare(arg)
                    if what:
                        emit(node, what, "stores")
        return findings


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _flat(expr: ast.AST) -> List[ast.AST]:
    if isinstance(expr, (ast.Tuple, ast.List)):
        return [e for el in expr.elts for e in _flat(el)]
    return [expr]


def _pairs(tgt: ast.AST, value: ast.AST):
    if isinstance(tgt, (ast.Tuple, ast.List)) and \
            isinstance(value, (ast.Tuple, ast.List)) and \
            len(tgt.elts) == len(value.elts):
        for t, v in zip(tgt.elts, value.elts):
            yield from _pairs(t, v)
    else:
        yield tgt, value
