"""Whole-program model: repo-wide symbol table, call graph, lock
graph, and thread-root inventory — built ONCE per run and shared by
every checker (the single-parse contract: ``RepoContext.program()``).

Before it, each checker reasoned one class at a time, which is exactly
why the circuit-breaker reset and the promote double-allocation
survived review: both were *cross-object* races. This module gives the
RTA1xx family (and the new RTA104-106) the global view:

- **Symbol table.** Repo-relative path -> dotted module name, the
  module-level import map (absolute + relative imports resolved to
  repo modules), every top-level class and function.
- **Attribute types, bounded.** ``self.x = ServingStats(...)`` (any
  call inside the RHS, so ``stats or ServingStats()`` resolves too),
  ``self.x = param`` where the parameter is annotated with a repo
  class, and one level of local aliasing (``s = self.stats``) inside a
  method. Class names resolve through the import map first, then by
  globally-unique simple name. Anything fancier (``getattr``, dicts of
  objects, factory indirection) is deliberately out of scope — the
  documented blind spots in docs/analysis.md.
- **Method summaries.** Per method: locks acquired directly (OWN locks
  and foreign ones taken via a typed attribute, both as
  class-qualified ids), resolved call sites with the lexically-held
  lock set, and whether the body makes a blocking call (the RTA102
  predicate, plus bus/cache round-trips via typed receivers).
- **Transitive closures, bounded.** Locks a method may acquire through
  its callees (fixpoint, capped at ``MAX_FIXPOINT_ROUNDS``) and the
  nearest blocking call reachable through the call graph (reverse BFS,
  capped at ``MAX_CHAIN_DEPTH`` frames) — with enough breadcrumbs to
  print the actual frame chain in a finding.
- **Thread roots.** Every ``Thread(target=...)``, executor
  ``submit(...)`` (method or locally-defined closure), and HTTP route
  handler (the repo's ``("GET", "/path", self._handler)`` route-tuple
  idiom) per class, plus intra-class reachability from each root — the
  basis of the RTA106 cross-thread shared-state inference.

Everything is stdlib ``ast`` over the already-parsed trees; nothing is
imported or executed.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import PKG

#: Lock/sync primitive construction, shared with guarded_state.
LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
ATOMIC_FACTORIES = {"Event", "Semaphore", "BoundedSemaphore", "Barrier",
                    "local", "Queue", "SimpleQueue", "LifoQueue",
                    "PriorityQueue"}
MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
            "pop", "popleft", "popitem", "remove", "discard", "clear",
            "update", "setdefault", "add"}

#: Module roots whose calls block (network, processes, disk trees).
BLOCKING_MODULES = {"subprocess", "socket", "requests", "urllib"}

#: Modules whose classes do a bus/broker round-trip per method call —
#: a call on a receiver typed to one of these blocks (network I/O).
BUS_MODULE_MARKERS = (f"{PKG}/bus/", f"{PKG}/cache.py")

#: Interprocedural bounds (the suite is a pre-commit gate: predictable
#: wall time beats completeness — anything deeper than these is a
#: documented blind spot, not a hang).
MAX_FIXPOINT_ROUNDS = 30
MAX_CHAIN_DEPTH = 8


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _dotted(node: ast.AST) -> List[str]:
    """``a.b.c(...)`` -> ["a", "b", "c"]; best effort."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return list(reversed(parts))


class _Access:
    __slots__ = ("attr", "held", "method", "line", "is_write", "nested",
                 "fn_stack")

    def __init__(self, attr, held, method, line, is_write, nested,
                 fn_stack=()):
        self.attr = attr
        self.held = held
        self.method = method
        self.line = line
        self.is_write = is_write
        self.nested = nested
        #: Names of the nested defs enclosing this access (innermost
        #: last) — empty for depth-0 method-body accesses. Lets RTA106
        #: attribute a closure's accesses to the thread root the
        #: closure was submitted to.
        self.fn_stack = fn_stack


def _foreign_lock_token(expr: ast.AST) -> Optional[str]:
    """``with self.stats._lock:`` — a lock REACHED through another
    object. Held-set token ``"stats._lock"`` (renders as
    ``self.stats._lock``): consistently guarding own state with a
    collaborator's lock is a real guard, and RTA101/102/106 must see
    it. Name-based (lock/cond/mutex leaf) because the per-class walk
    has no type information; the typed form feeds RTA104/105 via
    ``_QualifiedWalker``."""
    if isinstance(expr, ast.Attribute):
        owner = _self_attr(expr.value)
        leaf = expr.attr.lower()
        if owner is not None and ("lock" in leaf or "cond" in leaf
                                  or "mutex" in leaf):
            return f"{owner}.{expr.attr}"
    return None


#: Held-set tokens for module-GLOBAL locks taken inside a class method
#: (``with _REG_LOCK:``) carry this prefix + the module-qualified lock
#: id, so they can never collide with a self-attribute token and so
#: the same lock unifies across every class/function that shares it.
MODULE_LOCK_TOKEN = "::"


def held_display(token: str) -> str:
    """Render a held-set token the way the source spells it:
    ``self.<attr>`` for own/foreign attribute locks, the module-
    qualified name for module-global ones."""
    if token.startswith(MODULE_LOCK_TOKEN):
        return token[len(MODULE_LOCK_TOKEN):]
    return f"self.{token}"


class _MethodWalker(ast.NodeVisitor):
    """Walks one method body tracking the lexically-held lock set."""

    def __init__(self, cls: "_ClassInfo", method: str):
        self.cls = cls
        self.method = method
        self.held: Tuple[str, ...] = ()
        self.depth = 0  # nested function depth (closures run later)
        self.fn_stack: Tuple[str, ...] = ()

    # --- lock context ---

    def visit_With(self, node: ast.With) -> None:
        entered = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr in self.cls.lock_attrs:
                entered.append(attr)
                self.cls.lock_entries.append(
                    (frozenset(self.held), attr, item.context_expr.lineno,
                     self.method, self.depth))
            else:
                # Foreign and module-global locks enter the HELD set
                # (they guard) but not lock_entries (RTA103's ordering
                # stays own-lock).
                token = _foreign_lock_token(item.context_expr)
                if token is None and \
                        isinstance(item.context_expr, ast.Name) and \
                        item.context_expr.id in self.cls.module_locks:
                    token = MODULE_LOCK_TOKEN + \
                        self.cls.module_locks[item.context_expr.id]
                if token is None and \
                        isinstance(item.context_expr, ast.Attribute) \
                        and isinstance(item.context_expr.value,
                                       ast.Name):
                    # Dotted module-global lock (``with mod._LOCK:``)
                    # — the module_lock_names map keys the dotted
                    # spelling, so it yields the same qualified token
                    # as the bare-name form.
                    dotted = (f"{item.context_expr.value.id}."
                              f"{item.context_expr.attr}")
                    if dotted in self.cls.module_locks:
                        token = MODULE_LOCK_TOKEN + \
                            self.cls.module_locks[dotted]
                if token is not None:
                    entered.append(token)
                else:
                    self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        prior = self.held
        self.held = tuple(self.held) + tuple(entered)
        for stmt in node.body:
            self.visit(stmt)
        self.held = prior

    # --- scope boundaries ---

    def _enter_nested(self, node) -> None:
        prior, self.held = self.held, ()
        self.depth += 1
        name = getattr(node, "name", "<lambda>")
        prior_stack, self.fn_stack = \
            self.fn_stack, self.fn_stack + (name,)
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.fn_stack = prior_stack
        self.depth -= 1
        self.held = prior

    def visit_FunctionDef(self, node):
        self.cls.nested_defs.append((self.method, self.fn_stack,
                                     node.name, node))
        self._enter_nested(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._enter_nested(node)

    # --- accesses ---

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            self.cls.accesses.append(_Access(
                attr, frozenset(self.held), self.method, node.lineno,
                isinstance(node.ctx, (ast.Store, ast.Del)),
                self.depth > 0, self.fn_stack))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        self.cls.calls.append(
            (node, frozenset(self.held), self.method, self.depth,
             self.fn_stack))
        # A container-mutator call on a self attribute is a WRITE of
        # that attribute (RTA106 cares about writes, and `x.append` is
        # how most shared containers are written).
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATORS:
            owner = _self_attr(node.func.value)
            if owner is not None:
                self.cls.accesses.append(_Access(
                    owner, frozenset(self.held), self.method,
                    node.lineno, True, self.depth > 0, self.fn_stack))
        self.generic_visit(node)


class _ClassInfo:
    """One class's locks, state attributes, accesses and intra-class
    call graph — the unit the RTA1xx checkers (and the whole-program
    pass) share. Walked at most once per run via ``Program``."""

    def __init__(self, node: ast.ClassDef,
                 module_locks: Optional[Dict[str, str]] = None):
        self.node = node
        self.name = node.name
        #: local name -> module-qualified id for the module-global
        #: sync primitives visible where this class is defined: a
        #: ``with _REG_LOCK:`` in a method guards exactly like an own
        #: lock (the workload-recorder shape) — without this the
        #: guarded-state family reads such classes as lock-free.
        self.module_locks: Dict[str, str] = module_locks or {}
        self.lock_attrs: Set[str] = set()
        self.lock_kind: Dict[str, str] = {}      # attr -> factory name
        self.atomic_attrs: Set[str] = set()
        self.thread_attrs: Set[str] = set()
        self.state_attrs: Set[str] = set()
        self.accesses: List[_Access] = []
        # (node, held, method, nested-depth, fn_stack)
        self.calls: List[Tuple[ast.Call, frozenset, str, int, tuple]] = []
        # (outer_held, lock, line, method, nested-depth)
        self.lock_entries: List[Tuple[frozenset, str, int, str, int]] = []
        # (method, enclosing fn_stack, def name, node)
        self.nested_defs: List[Tuple[str, tuple, str, ast.AST]] = []
        self._walked = False

    # -- pass 1: classify attributes --

    def classify(self) -> None:
        for method in self._methods():
            in_init = method.name == "__init__"
            for sub in ast.walk(method):
                if isinstance(sub, (ast.Assign, ast.AnnAssign,
                                    ast.AugAssign)):
                    targets = (sub.targets
                               if isinstance(sub, ast.Assign)
                               else [sub.target])
                    for tgt in targets:
                        self._classify_target(tgt, sub, in_init)
                elif isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute):
                    owner = _self_attr(sub.func.value)
                    if owner is not None and sub.func.attr in MUTATORS:
                        self.state_attrs.add(owner)

    def _classify_target(self, tgt: ast.AST, stmt, in_init: bool) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._classify_target(el, stmt, in_init)
            return
        if isinstance(tgt, ast.Subscript):
            owner = _self_attr(tgt.value)
            if owner is not None:
                self.state_attrs.add(owner)
            return
        attr = _self_attr(tgt)
        if attr is None:
            return
        value = getattr(stmt, "value", None)
        factory = self._factory_of(value)
        if factory in LOCK_FACTORIES:
            self.lock_attrs.add(attr)
            self.lock_kind[attr] = factory
            return
        if factory in ATOMIC_FACTORIES:
            self.atomic_attrs.add(attr)
            return
        if factory == "Thread":
            self.thread_attrs.add(attr)
        if not in_init:
            self.state_attrs.add(attr)

    @staticmethod
    def _factory_of(value) -> Optional[str]:
        if isinstance(value, ast.Call):
            parts = _dotted(value.func)
            if parts:
                return parts[-1]
        return None

    def _methods(self):
        for item in self.node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield item

    def methods(self) -> List[ast.FunctionDef]:
        return list(self._methods())

    # -- pass 2: walk --

    def walk(self) -> None:
        if self._walked:
            return
        self._walked = True
        for method in self._methods():
            walker = _MethodWalker(self, method.name)
            for stmt in method.body:
                walker.visit(stmt)

    # -- held-by-callers fixpoint --

    def held_extra(self) -> Dict[str, frozenset]:
        """Locks a private method may assume held because every
        intra-class call site holds them."""
        cached = getattr(self, "_held_extra", None)
        if cached is not None:
            return cached
        sites: Dict[str, List[Tuple[frozenset, str, int]]] = {}
        for call, held, method, depth, _fns in self.calls:
            callee = _self_attr(call.func) \
                if isinstance(call.func, ast.Attribute) else None
            if callee and callee.startswith("_") and depth == 0:
                sites.setdefault(callee, []).append(
                    (held, method, depth))
        extra: Dict[str, frozenset] = {}
        for _ in range(3):  # call chains are shallow; 3 is plenty
            changed = False
            for callee, callsites in sites.items():
                effective = [held | extra.get(method, frozenset())
                             for held, method, _ in callsites]
                new = frozenset.intersection(*effective) if effective \
                    else frozenset()
                if new != extra.get(callee, frozenset()):
                    extra[callee] = new
                    changed = True
            if not changed:
                break
        self._held_extra = extra
        return extra

    # -- acquired-locks fixpoint (intra-class, for RTA103) --

    def acquired(self) -> Dict[str, Set[str]]:
        direct: Dict[str, Set[str]] = {}
        callees: Dict[str, Set[str]] = {}
        for held, lock, _line, method, depth in self.lock_entries:
            if depth == 0:
                direct.setdefault(method, set()).add(lock)
        for call, _held, method, depth, _fns in self.calls:
            callee = _self_attr(call.func) \
                if isinstance(call.func, ast.Attribute) else None
            if callee and depth == 0:
                callees.setdefault(method, set()).add(callee)
        acq = {m: set(locks) for m, locks in direct.items()}
        for _ in range(3):
            changed = False
            for method, cs in callees.items():
                cur = acq.setdefault(method, set())
                for c in cs:
                    extra = acq.get(c, set()) - cur
                    if extra:
                        cur.update(extra)
                        changed = True
            if not changed:
                break
        return acq

    # -- intra-class self-call graph + thread roots (RTA106 basis) --

    def self_call_graph(self) -> Dict[str, Set[str]]:
        """method -> self-methods it calls at depth 0 (closures are
        attributed to the root that RUNS them, not the method that
        defines them)."""
        graph: Dict[str, Set[str]] = {}
        for call, _held, method, depth, _fns in self.calls:
            callee = _self_attr(call.func) \
                if isinstance(call.func, ast.Attribute) else None
            if callee and depth == 0:
                graph.setdefault(method, set()).add(callee)
        return graph

    def thread_roots(self) -> Dict[str, Tuple[str, str]]:
        """root id -> (kind, detail). Roots are the entrypoints OTHER
        threads run:

        - ``thread:<m>`` — ``Thread(target=self.m)`` anywhere in the
          class (also ``run_in_thread``-style wrappers taking a bound
          method as ``target=``);
        - ``submit:<m>`` / ``submit:<meth>/<fn>`` — an executor
          ``submit`` of a bound method or of a closure defined in
          ``<meth>``;
        - ``handler:<m>`` — the repo's HTTP route-tuple idiom
          ``("GET", "/path", self.m)`` (JsonHttpServer dispatches on
          per-request server threads).
        """
        roots: Dict[str, Tuple[str, str]] = {}
        local_defs = {(m, name) for m, _stack, name, _n
                      in self.nested_defs}

        def root_of(arg: ast.AST, method: str) -> Optional[str]:
            attr = _self_attr(arg)
            if attr is not None:
                return attr
            if isinstance(arg, ast.Name) and \
                    (method, arg.id) in local_defs:
                return f"{method}/{arg.id}"
            return None

        for call, _held, method, _depth, _fns in self.calls:
            func = call.func
            leaf = func.attr if isinstance(func, ast.Attribute) else \
                (func.id if isinstance(func, ast.Name) else "")
            if leaf == "Thread":
                for kw in call.keywords:
                    if kw.arg == "target":
                        r = root_of(kw.value, method)
                        if r:
                            roots[f"thread:{r}"] = ("thread", r)
            elif leaf == "submit" and call.args:
                # Only executor-shaped receivers: self.<pool>.submit /
                # <local>.submit — predictor.predict_submit-style app
                # methods are not thread hops.
                owner = func.value if isinstance(func, ast.Attribute) \
                    else None
                ownername = (_self_attr(owner) or
                             (owner.id if isinstance(owner, ast.Name)
                              else "")) if owner is not None else ""
                if "pool" in ownername or "executor" in ownername \
                        or "exec" in ownername:
                    r = root_of(call.args[0], method)
                    if r:
                        roots[f"submit:{r}"] = ("submit", r)
        # Route tuples: ("GET", "/path", self.m) anywhere in the class.
        for node in ast.walk(self.node):
            if isinstance(node, (ast.Tuple, ast.List)) and \
                    len(node.elts) == 3 and \
                    all(isinstance(e, ast.Constant) and
                        isinstance(e.value, str)
                        for e in node.elts[:2]):
                attr = _self_attr(node.elts[2])
                if attr is not None and \
                        node.elts[0].value.upper() in (
                            "GET", "POST", "PUT", "DELETE", "PATCH"):
                    roots[f"handler:{attr}"] = ("handler", attr)
        return roots


# --- whole-program model ----------------------------------------------


class ModuleInfo:
    """One module's place in the program: dotted name, import map,
    top-level classes and functions."""

    def __init__(self, rel: str, tree: Optional[ast.AST]):
        self.rel = rel
        self.modname = rel[:-3].replace("/", ".")
        if self.modname.endswith(".__init__"):
            self.modname = self.modname[: -len(".__init__")]
        self.tree = tree
        #: local name -> (modname, symbol-or-None): `import a.b as c`
        #: -> {"c": ("a.b", None)}; `from a import X` -> {"X": ("a","X")}
        self.imports: Dict[str, Tuple[str, Optional[str]]] = {}
        #: dotted module names imported AT MODULE LEVEL (import-time
        #: executed), for the RTA602 reachability pass. Excludes
        #: TYPE_CHECKING / __main__ guarded blocks.
        self.import_time: List[Tuple[str, int]] = []
        self.classes: Dict[str, ast.ClassDef] = {}
        self.functions: Dict[str, ast.FunctionDef] = {}
        #: Names bound at PLAIN top level to a lock factory
        #: (``_lock = threading.Lock()``) — the module-global sync
        #: primitives free functions guard with. Deliberately not the
        #: recursive ``_toplevel_stmts`` walk: that descends into class
        #: bodies, and a class-attribute lock is the class's, not the
        #: module's.
        self.global_locks: Set[str] = set()
        if tree is None:
            return
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                parts = _dotted(node.value.func)
                if parts and parts[-1] in LOCK_FACTORIES:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            self.global_locks.add(tgt.id)
        pkg = self.modname if rel.endswith("__init__.py") else \
            self.modname.rsplit(".", 1)[0] if "." in self.modname else ""
        for node, guarded in _toplevel_stmts(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else \
                        alias.name.split(".")[0]
                    self.imports[local] = (target, None)
                    if not guarded:
                        self.import_time.append((alias.name,
                                                 node.lineno))
            elif isinstance(node, ast.ImportFrom):
                base = _resolve_from(pkg, node)
                if base is None:
                    continue
                for alias in node.names:
                    local = alias.asname or alias.name
                    self.imports[local] = (base, alias.name)
                    if not guarded:
                        self.import_time.append(
                            (f"{base}.{alias.name}", node.lineno))
                if not guarded:
                    self.import_time.append((base, node.lineno))


def _resolve_from(pkg: str, node: ast.ImportFrom) -> Optional[str]:
    """Absolute dotted base of a ``from X import ...``. ``pkg`` is the
    module's OWN package (for a package ``__init__`` that is the
    package itself): level=1 resolves against it, each extra level
    climbs one parent. None when the climb leaves the repo."""
    if node.level == 0:
        return node.module or ""
    parts = pkg.split(".") if pkg else []
    climb = node.level - 1
    if climb > len(parts):
        return None
    base = ".".join(parts[: len(parts) - climb] if climb else parts)
    if node.module:
        base = f"{base}.{node.module}" if base else node.module
    return base


def _guard_polarity(test: ast.AST) -> Optional[str]:
    """Which branch of an If does NOT execute on a bare import:
    ``"body"`` for ``if __name__ == "__main__":`` / ``if
    TYPE_CHECKING:``, ``"orelse"`` for the inverted spellings
    (``__name__ != ...``, ``not TYPE_CHECKING``), None for an
    ordinary If. The OTHER branch still runs at import — a
    ``TYPE_CHECKING: ... else: X = Any`` else-arm must stay in
    scope."""
    def is_tc_name(n: ast.AST) -> bool:
        return (isinstance(n, ast.Name) and n.id == "TYPE_CHECKING") \
            or (isinstance(n, ast.Attribute) and
                n.attr == "TYPE_CHECKING")

    if is_tc_name(test):
        return "body"
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and is_tc_name(test.operand):
        return "orelse"
    if isinstance(test, ast.Compare) and \
            isinstance(test.left, ast.Name) and \
            test.left.id == "__name__" and len(test.ops) == 1:
        if isinstance(test.ops[0], ast.Eq):
            return "body"
        if isinstance(test.ops[0], ast.NotEq):
            return "orelse"
    return None


def _toplevel_stmts(tree: ast.AST):
    """Yield (stmt, guarded) for every statement that EXECUTES at
    import time: module body recursively through if/try/with/for
    blocks and class bodies, never into function bodies. ``guarded``
    is True only for the branch a ``__name__ == "__main__"`` /
    ``TYPE_CHECKING`` test keeps off the bare-import path (polarity
    respected: the else-arm of a guard, and the body of an inverted
    guard, still run at import)."""
    # LIFO stack with reversed pushes = document order out, which the
    # thread-name tracking in import_hygiene relies on (the Thread
    # assignment must be seen before its .start()).
    stack: List[Tuple[ast.AST, bool]] = \
        [(s, False) for s in reversed(tree.body)]
    while stack:
        node, guarded = stack.pop()
        yield node, guarded
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.ClassDef):
            for s in reversed(node.body):
                if not isinstance(s, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    stack.append((s, guarded))
            continue
        polarity = _guard_polarity(node.test) \
            if isinstance(node, ast.If) else None
        children: List[Tuple[ast.AST, bool]] = []
        for field in ("body", "orelse", "finalbody", "handlers",
                      "cases"):
            g = guarded or polarity == field
            for child in getattr(node, field, []):
                if isinstance(child, ast.ExceptHandler):
                    for s in child.body:
                        children.append((s, g))
                elif child.__class__.__name__ == "match_case":
                    # match arms execute at import like any branch.
                    for s in child.body:
                        children.append((s, g))
                else:
                    children.append((child, g))
        stack.extend(reversed(children))


class MethodSummary:
    __slots__ = ("key", "node", "cls_key", "direct_locks", "calls",
                 "call_nodes", "blocking", "held_blocking")

    def __init__(self, key, node, cls_key):
        self.key = key          # (rel, clsname-or-None, methodname)
        self.node = node
        self.cls_key = cls_key  # (rel, clsname) or None
        #: (qualified lock id, frozenset of qualified outer held, line)
        self.direct_locks: List[Tuple[str, frozenset, int]] = []
        #: (frozenset of qualified held, target key or None, line, label)
        self.calls: List[Tuple[frozenset, Optional[tuple], int, str]] = []
        #: (target key or None, the ast.Call node) — the cross-process
        #: checkers (RTA7xx) re-examine resolved call sites with their
        #: actual argument expressions (queue-name forwarding, flag-gate
        #: classification); the lock-graph tuple above stays lean.
        self.call_nodes: List[Tuple[Optional[tuple], ast.Call]] = []
        #: (label, line) of the first direct blocking call, or None.
        self.blocking: Optional[Tuple[str, int]] = None
        #: Direct blocking calls made WITH a qualified lock held:
        #: (held, label, line). For free functions this is the only
        #: blocking-under-lock signal there is — the per-class RTA102
        #: never sees module-level code.
        self.held_blocking: List[Tuple[frozenset, str, int]] = []


class Program:
    """The built model. Construction is bounded and pure-AST; see the
    module docstring for exactly what resolves and what is a blind
    spot."""

    def __init__(self, modules: Sequence):
        # `modules` are core.Module objects (rel/tree/text); typed
        # loosely so this file keeps zero imports from core.
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_modname: Dict[str, ModuleInfo] = {}
        self._class_infos: Dict[int, _ClassInfo] = {}
        self._mods = list(modules)
        for m in self._mods:
            mi = ModuleInfo(m.rel, m.tree)
            self.modules[m.rel] = mi
            self.by_modname[mi.modname] = mi
        # Globally-unique simple-name class index (resolution fallback)
        # + node -> defining module (class_info needs the module's
        # global-lock names to walk `with <MODULE_LOCK>:` correctly).
        self._classes_by_name: Dict[str, List[Tuple[str, ast.ClassDef]]] = {}
        self._class_module: Dict[int, str] = {}
        for mi in self.modules.values():
            for cname, cnode in mi.classes.items():
                self._classes_by_name.setdefault(cname, []).append(
                    (mi.rel, cnode))
                self._class_module[id(cnode)] = mi.rel
        self._attr_types: Dict[Tuple[str, str], Dict[str, Tuple[str, str]]] = {}
        self._module_locks: Dict[str, Dict[str, str]] = {}
        self._module_state: Dict[str, "ModuleState"] = {}
        self._extra_roots: Optional[
            Dict[Tuple[str, str], Dict[str, Tuple[str, str]]]] = None
        self._summaries: Optional[Dict[tuple, MethodSummary]] = None
        self._locks_closure: Optional[Dict[tuple, Set[str]]] = None
        self._lock_via: Dict[tuple, Dict[str, tuple]] = {}
        self._blocking_closure: Optional[
            Dict[tuple, Tuple[str, int, tuple]]] = None

    # -- shared per-class analysis (guarded_state + concurrency) --

    def class_info(self, node: ast.ClassDef) -> _ClassInfo:
        """The classified+walked :class:`_ClassInfo` for this ClassDef,
        computed at most once per run regardless of how many checkers
        ask."""
        info = self._class_infos.get(id(node))
        if info is None:
            rel = self._class_module.get(id(node))
            locks = self.module_lock_names(rel) if rel else {}
            info = _ClassInfo(node, module_locks=locks)
            info.classify()
            info.walk()
            self._class_infos[id(node)] = info
        return info

    # -- class resolution --

    def resolve_class(self, rel: str,
                      name: str) -> Optional[Tuple[str, str]]:
        """(rel, classname) a simple name refers to in module ``rel``:
        import-map first, globally-unique simple name second."""
        mi = self.modules.get(rel)
        if mi is None:
            return None
        if name in mi.classes:
            return (rel, name)
        imp = mi.imports.get(name)
        if imp is not None:
            modname, symbol = imp
            target = self.by_modname.get(modname)
            if target is not None and symbol is None and \
                    name in target.classes:
                return (target.rel, name)
            if symbol is not None and target is not None and \
                    symbol in target.classes:
                return (target.rel, symbol)
        hits = self._classes_by_name.get(name, [])
        if len(hits) == 1:
            return (hits[0][0], name)
        return None

    def class_display(self, cls_key: Tuple[str, str]) -> str:
        rel, name = cls_key
        if len(self._classes_by_name.get(name, [])) > 1:
            stem = rel.rsplit("/", 1)[-1][:-3]
            return f"{stem}.{name}"
        return name

    def lock_id(self, cls_key: Tuple[str, str], attr: str) -> str:
        return f"{self.class_display(cls_key)}.{attr}"

    def lock_owner(self, lock_id: str) -> str:
        return lock_id.rsplit(".", 1)[0]

    # -- attribute types (bounded alias following) --

    def attr_types(self, cls_key: Tuple[str, str]) -> Dict[str, Tuple[str, str]]:
        """attr -> (rel, classname) for attributes whose constructed /
        annotated type resolves to a repo class."""
        cached = self._attr_types.get(cls_key)
        if cached is not None:
            return cached
        rel, cname = cls_key
        mi = self.modules.get(rel)
        node = mi.classes.get(cname) if mi else None
        out: Dict[str, Tuple[str, str]] = {}
        if node is not None:
            info = self.class_info(node)
            for meth in info.methods():
                ann: Dict[str, Tuple[str, str]] = {}
                for a in meth.args.args + meth.args.kwonlyargs:
                    t = self._annotation_class(rel, a.annotation)
                    if t is not None:
                        ann[a.arg] = t
                for stmt in ast.walk(meth):
                    if not isinstance(stmt, ast.Assign):
                        continue
                    for tgt in stmt.targets:
                        attr = _self_attr(tgt)
                        if attr is None or attr in out:
                            continue
                        t = self._rhs_class(rel, stmt.value, ann)
                        if t is not None:
                            out[attr] = t
        self._attr_types[cls_key] = out
        return out

    def _annotation_class(self, rel: str,
                          ann) -> Optional[Tuple[str, str]]:
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            name = ann.value.strip().lstrip("\"'").split("[")[0]
            name = name.split(".")[-1]
            return self.resolve_class(rel, name)
        parts = _dotted(ann)
        if parts:
            return self.resolve_class(rel, parts[-1])
        return None

    def _rhs_class(self, rel: str, value: ast.AST,
                   ann: Dict[str, Tuple[str, str]]
                   ) -> Optional[Tuple[str, str]]:
        """Type of an assignment RHS: the first constructor call of a
        resolvable repo class anywhere in the expression (covers
        ``stats or ServingStats()``), or an annotated parameter."""
        if isinstance(value, ast.Name) and value.id in ann:
            return ann[value.id]
        if isinstance(value, ast.BoolOp):
            for v in value.values:
                t = self._rhs_class(rel, v, ann)
                if t is not None:
                    return t
            return None
        for sub in ast.walk(value):
            if isinstance(sub, ast.Call):
                parts = _dotted(sub.func)
                if parts:
                    t = self.resolve_class(rel, parts[-1])
                    if t is not None:
                        return t
        return None

    # -- module-global locks --

    def module_lock_names(self, rel: str) -> Dict[str, str]:
        """local name -> module-qualified lock id for the module-global
        sync primitives visible in ``rel``: its own top-level
        ``NAME = threading.Lock()`` binds plus ``from x import NAME``
        of another repo module's. Qualified as ``<modname>.<NAME>`` so
        ``lock_owner`` yields the module — the cross-owner filters
        treat a module exactly like a class."""
        cached = self._module_locks.get(rel)
        if cached is not None:
            return cached
        out: Dict[str, str] = {}
        mi = self.modules.get(rel)
        if mi is not None:
            for local, (modname, symbol) in mi.imports.items():
                if symbol is None:
                    # ``import pkg.mod as m`` — m's locks are only
                    # reachable as DOTTED ``m.LOCK`` references; the
                    # dotted spelling is the map key so both walkers
                    # resolve it with one lookup.
                    target = self.by_modname.get(modname)
                    if target is not None:
                        for name in target.global_locks:
                            out[f"{local}.{name}"] = \
                                f"{target.modname}.{name}"
                    continue
                target = self.by_modname.get(modname)
                if target is not None and \
                        symbol in target.global_locks:
                    out[local] = f"{target.modname}.{symbol}"
                # ``from pkg import mod`` — a module imported as a
                # SYMBOL: its locks are dotted ``mod.LOCK`` references
                # exactly like the aliased-import case.
                sub = self.by_modname.get(f"{modname}.{symbol}"
                                          if modname else symbol)
                if sub is not None:
                    for name in sub.global_locks:
                        out[f"{local}.{name}"] = \
                            f"{sub.modname}.{name}"
            for name in mi.global_locks:
                out[name] = f"{mi.modname}.{name}"
        self._module_locks[rel] = out
        return out

    # -- module-global mutable state (free-function RTA101) --

    def module_state(self, rel: str) -> "ModuleState":
        """The module-level analog of ``_ClassInfo`` state tracking:
        names bound at top level AND rebound via ``global`` in at
        least one free function are the module's mutable state; every
        free-function access is recorded with the module-lock held
        set. Names a function assigns WITHOUT declaring ``global`` are
        that function's locals (Python scoping) and are skipped there.
        Depth-0 only — closures run later and inherit nothing."""
        cached = self._module_state.get(rel)
        if cached is not None:
            return cached
        ms = ModuleState()
        mi = self.modules.get(rel)
        if mi is None or mi.tree is None:
            self._module_state[rel] = ms
            return ms
        top_bound: Set[str] = set()
        for stmt, _guarded in _toplevel_stmts(mi.tree):
            if isinstance(stmt, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                for tgt in targets:
                    if isinstance(tgt, ast.Name):
                        top_bound.add(tgt.id)
        fn_globals: Dict[str, Set[str]] = {}
        declared: Set[str] = set()
        for fname, fnode in mi.functions.items():
            g: Set[str] = set()
            for sub in ast.walk(fnode):
                if isinstance(sub, ast.Global):
                    g.update(sub.names)
            fn_globals[fname] = g
            declared.update(g)
        locks = self.module_lock_names(rel)
        ms.candidates = (declared & top_bound) - mi.global_locks
        if ms.candidates and locks:
            for fname, fnode in mi.functions.items():
                stored: Set[str] = set()
                for sub in ast.walk(fnode):
                    if isinstance(sub, ast.Name) and \
                            isinstance(sub.ctx, (ast.Store, ast.Del)):
                        stored.add(sub.id)
                skip = (stored - fn_globals[fname]) & ms.candidates
                walker = _ModuleStateWalker(locks, ms.candidates, skip,
                                            fname, ms.accesses)
                for stmt in fnode.body:
                    walker.visit(stmt)
        self._module_state[rel] = ms
        return ms

    # -- cross-class thread roots --

    def extra_class_roots(self, cls_key: Tuple[str, str]
                          ) -> Dict[str, Tuple[str, str]]:
        """Thread roots REGISTERED FROM OUTSIDE the class:
        ``Thread(target=self.consumer.loop)`` or an executor
        ``pool.submit(self.consumer.drain)`` in an owner (or a free
        function, through a local alias) makes the method a root ON
        the consumer's class — the bus-consumer / decode-scheduler
        shape, where the object that OWNS the loop never constructs
        the thread and so ``_ClassInfo.thread_roots`` is blind to it.
        Only executor-shaped submit receivers (pool/executor/exec in
        the name), receivers whose type resolves through the bounded
        alias rules, and methods the target class actually defines,
        register. Handler classes passed to a ``*Server`` ctor
        (the socketserver shape — ``handle()`` runs per-connection
        threads) register through the same inventory."""
        if self._extra_roots is None:
            self._extra_roots = {}
            for mi in self.modules.values():
                for cname, cnode in mi.classes.items():
                    info = self.class_info(cnode)
                    atypes = self.attr_types((mi.rel, cname))
                    for m in info.methods():
                        self._collect_foreign_targets(
                            mi.rel, (mi.rel, cname), atypes,
                            self._local_types(mi.rel, (mi.rel, cname),
                                              m, atypes), m)
                for fnode in mi.functions.values():
                    self._collect_foreign_targets(
                        mi.rel, None, {},
                        self._local_types(mi.rel, None, fnode, {}),
                        fnode)
        return self._extra_roots.get(cls_key, {})

    def spawn_params(self) -> Dict[tuple, Dict[str, str]]:
        """method/function key -> {param name: kind} for SPAWNER
        helpers: functions whose body hands one of their own
        parameters to ``Thread(target=param)`` or an executor
        ``submit(param)``. A callable passed to such a parameter runs
        on another thread — the ``register_consumer`` shape, where the
        class that OWNS the loop method hands it to a different
        class's spawn helper and neither per-class walk sees a root."""
        cached = getattr(self, "_spawn_params", None)
        if cached is not None:
            return cached
        out: Dict[tuple, Dict[str, str]] = {}
        for key, s in self.summaries().items():
            params = {a.arg for a in s.node.args.args +
                      s.node.args.kwonlyargs}
            if not params:
                continue
            for node in ast.walk(s.node):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                leaf = func.attr if isinstance(func, ast.Attribute) \
                    else (func.id if isinstance(func, ast.Name) else "")
                if leaf == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target" and \
                                isinstance(kw.value, ast.Name) and \
                                kw.value.id in params:
                            out.setdefault(key, {})[kw.value.id] = \
                                "thread"
                elif leaf == "submit" and node.args and \
                        isinstance(node.args[0], ast.Name) and \
                        node.args[0].id in params:
                    owner = func.value \
                        if isinstance(func, ast.Attribute) else None
                    ownername = (_self_attr(owner) or
                                 (owner.id if isinstance(owner, ast.Name)
                                  else "")) if owner is not None else ""
                    if "pool" in ownername or "executor" in ownername \
                            or "exec" in ownername:
                        out.setdefault(key, {})[node.args[0].id] = \
                            "submit"
        self._spawn_params = out
        return out

    def _spawned_args(self, rel, cls_key, node: ast.Call, atypes,
                      local_types) -> List[Tuple[str, ast.AST]]:
        """(kind, callable expression) for arguments this call hands
        to a spawner helper's spawn parameter (``spawn_params``)."""
        target, _label = self._resolve_call(rel, cls_key, node, atypes,
                                            local_types)
        if target is None:
            return []
        spawn = self.spawn_params().get(target)
        if not spawn:
            return []
        s = self.summaries().get(target)
        if s is None:
            return []
        params = [a.arg for a in s.node.args.args]
        offset = 1 if target[1] is not None and params and \
            params[0] == "self" else 0
        out: List[Tuple[str, ast.AST]] = []
        for i, arg in enumerate(node.args):
            j = offset + i
            if j < len(params) and params[j] in spawn:
                out.append((spawn[params[j]], arg))
        for kw in node.keywords:
            if kw.arg in spawn:
                out.append((spawn[kw.arg], kw.value))
        return out

    def _collect_foreign_targets(self, rel, cls_key, atypes,
                                 local_types, fnode) -> None:
        for node in ast.walk(fnode):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            leaf = func.attr if isinstance(func, ast.Attribute) else \
                (func.id if isinstance(func, ast.Name) else "")
            # (kind, target expression) candidates this call registers.
            targets: List[Tuple[str, ast.AST]] = []
            if leaf == "Thread":
                targets.extend(
                    ("thread", kw.value) for kw in node.keywords
                    if kw.arg == "target")
            elif leaf == "submit" and node.args:
                # Executor-shaped receivers only (same vocabulary as
                # _ClassInfo.thread_roots): pool.submit(c.loop) is a
                # thread hop; app.submit(self.x.m) is an app method.
                owner = func.value \
                    if isinstance(func, ast.Attribute) else None
                ownername = (_self_attr(owner) or
                             (owner.id if isinstance(owner, ast.Name)
                              else "")) if owner is not None else ""
                if "pool" in ownername or "executor" in ownername \
                        or "exec" in ownername:
                    targets.append(("submit", node.args[0]))
            # A callable handed to ANOTHER function's spawn parameter
            # (``helper.register_consumer(self.consumer.loop)``) is a
            # root exactly like a direct Thread(target=...) here.
            targets.extend(self._spawned_args(rel, cls_key, node,
                                              atypes, local_types))
            for kind, value in targets:
                if not isinstance(value, ast.Attribute):
                    continue
                recv, meth = value.value, value.attr
                attr = _self_attr(recv)
                fk = atypes.get(attr) if attr is not None else None
                if fk is None and isinstance(recv, ast.Name):
                    fk = local_types.get(recv.id)
                if fk is None:
                    continue
                finfo = self._class_info_of(fk)
                if finfo is None or not any(m.name == meth
                                            for m in finfo.methods()):
                    continue
                self._extra_roots.setdefault(fk, {})[
                    f"{kind}:{meth}"] = (kind, meth)
            self._collect_handler_roots(rel, node, func, leaf)

    def _collect_handler_roots(self, rel, node: ast.Call, func,
                               leaf: str) -> None:
        """The socketserver shape: ``_Server((host, port), _Handler)``
        — the server ctor takes the handler CLASS and calls its
        ``handle()`` on a per-connection thread, so the handler class
        never constructs a thread and both thread-root walks are blind
        to it. Bounded: the called name must resolve to a repo class
        with a ``*Server*`` base (socketserver.ThreadingTCPServer and
        repo subclasses), the argument to a repo class that defines
        ``handle``."""
        called = self.resolve_class(rel, leaf) if leaf else None
        if called is None or not self._is_server_class(called):
            return
        candidates = list(node.args) + [
            kw.value for kw in node.keywords
            if kw.arg and "handler" in kw.arg.lower()]
        for arg in candidates:
            if not isinstance(arg, ast.Name):
                continue
            hk = self.resolve_class(rel, arg.id)
            if hk is None:
                continue
            hinfo = self._class_info_of(hk)
            if hinfo is None or not any(m.name == "handle"
                                        for m in hinfo.methods()):
                continue
            self._extra_roots.setdefault(hk, {})[
                "handler:handle"] = ("handler", "handle")

    def _is_server_class(self, cls_key: Tuple[str, str]) -> bool:
        mi = self.modules.get(cls_key[0])
        cnode = mi.classes.get(cls_key[1]) if mi else None
        if cnode is None:
            return False
        return any("Server" in part
                   for base in cnode.bases for part in _dotted(base))

    # -- method summaries + call resolution --

    def summaries(self) -> Dict[tuple, MethodSummary]:
        if self._summaries is None:
            self._summaries = {}
            # Phase 1: register EVERY method/function key first —
            # resolution during the fill phase must see the whole
            # program, not the build-order prefix.
            for mi in self.modules.values():
                for cname, cnode in mi.classes.items():
                    info = self.class_info(cnode)
                    for m in info.methods():
                        self._summaries[(mi.rel, cname, m.name)] = \
                            MethodSummary((mi.rel, cname, m.name), m,
                                          (mi.rel, cname))
                for fname, fnode in mi.functions.items():
                    self._summaries[(mi.rel, None, fname)] = \
                        MethodSummary((mi.rel, None, fname), fnode,
                                      None)
            # Phase 2: fill.
            for mi in self.modules.values():
                for cname, cnode in mi.classes.items():
                    self._build_class_summaries(mi.rel, cname, cnode)
                for fname, fnode in mi.functions.items():
                    self._build_function_summary(mi.rel, fname, fnode)
        return self._summaries

    def method(self, cls_key: Tuple[str, str],
               name: str) -> Optional[MethodSummary]:
        return self.summaries().get((cls_key[0], cls_key[1], name))

    def _build_function_summary(self, rel: str, fname: str,
                                fnode) -> None:
        """Module-level functions: no self, but module-GLOBAL locks
        (top-level ``NAME = threading.Lock()``, own or from-imported)
        qualify and their ``with NAME:`` holds track, so free-function
        acquisitions feed the cross-owner lock graph (RTA104) and the
        blocking closure (RTA105) exactly like class locks do."""
        s = self._summaries[(rel, None, fname)]
        walker = _QualifiedWalker(self, rel, None, _FREE_CONTEXT, {},
                                  s, frozenset())
        for stmt in fnode.body:
            walker.visit(stmt)

    def _build_class_summaries(self, rel: str, cname: str,
                               cnode: ast.ClassDef) -> None:
        info = self.class_info(cnode)
        cls_key = (rel, cname)
        atypes = self.attr_types(cls_key)
        for mnode in info.methods():
            s = self._summaries[(rel, cname, mnode.name)]
            extra_q = frozenset(
                self.lock_id(cls_key, h)
                for h in info.held_extra().get(mnode.name, ()))
            walker = _QualifiedWalker(self, rel, cls_key, info, atypes,
                                      s, extra_q)
            for stmt in mnode.body:
                walker.visit(stmt)

    def _class_info_of(self,
                       cls_key: Tuple[str, str]) -> Optional[_ClassInfo]:
        mi = self.modules.get(cls_key[0])
        node = mi.classes.get(cls_key[1]) if mi else None
        return self.class_info(node) if node is not None else None

    def _local_types(self, rel, cls_key, mnode, atypes):
        """One level of local alias following inside a method:
        ``s = self.stats`` / ``s = ServingStats(...)`` / annotated
        params. Flow-insensitive, last-writer-wins-free (first binding
        recorded) — bounded by design."""
        out: Dict[str, Tuple[str, str]] = {}
        if mnode is None:
            return out
        cached = getattr(mnode, "_rta_local_types", None)
        if cached is not None:
            return cached
        for a in mnode.args.args + mnode.args.kwonlyargs:
            t = self._annotation_class(rel, a.annotation)
            if t is not None:
                out[a.arg] = t
        for stmt in ast.walk(mnode):
            if not isinstance(stmt, ast.Assign) or \
                    len(stmt.targets) != 1 or \
                    not isinstance(stmt.targets[0], ast.Name):
                continue
            name = stmt.targets[0].id
            if name in out:
                continue
            v = stmt.value
            attr = _self_attr(v)
            if attr is not None and attr in atypes:
                out[name] = atypes[attr]
            elif isinstance(v, ast.Call):
                parts = _dotted(v.func)
                if parts:
                    t = self.resolve_class(rel, parts[-1])
                    if t is not None:
                        out[name] = t
        mnode._rta_local_types = out
        return out

    def _resolve_call(self, rel, cls_key, call, atypes, local_types
                      ) -> Tuple[Optional[tuple], str]:
        """(target method key or None, display label)."""
        func = call.func
        if isinstance(func, ast.Name):
            # Constructor or module-level function.
            ck = self.resolve_class(rel, func.id)
            if ck is not None:
                init = self.summaries_key(ck, "__init__")
                return init, f"{self.class_display(ck)}()"
            fk = self._module_function(rel, func.id)
            return fk, f"{func.id}()"
        if not isinstance(func, ast.Attribute):
            return None, ""
        meth = func.attr
        recv = func.value
        attr = _self_attr(recv)
        if attr is not None:
            # self.attr.m() through a typed attribute.
            fk = atypes.get(attr)
            if fk is not None:
                return (self.summaries_key(fk, meth),
                        f"self.{attr}.{meth}()")
            return None, f"self.{attr}.{meth}()"
        if isinstance(recv, ast.Name):
            if recv.id == "self":
                key = self._self_method(cls_key, meth)
                return key, f"self.{meth}()"
            fk = local_types.get(recv.id)
            if fk is not None:
                return (self.summaries_key(fk, meth),
                        f"{recv.id}.{meth}()")
            imp = self.modules[rel].imports.get(recv.id) \
                if rel in self.modules else None
            if imp is not None:
                target = self.by_modname.get(
                    imp[0] if imp[1] is None else f"{imp[0]}.{imp[1]}")
                if target is None:
                    target = self.by_modname.get(imp[0])
                if target is not None and meth in target.functions:
                    return ((target.rel, None, meth),
                            f"{recv.id}.{meth}()")
        return None, ""

    def _self_method(self, cls_key, meth) -> Optional[tuple]:
        """``self.m()`` — own class first, then resolvable repo base
        classes (single-level MRO-by-name)."""
        if cls_key is None:
            return None
        key = (cls_key[0], cls_key[1], meth)
        if key in self.summaries():
            return key
        mi = self.modules.get(cls_key[0])
        node = mi.classes.get(cls_key[1]) if mi else None
        if node is None:
            return None
        for base in node.bases:
            parts = _dotted(base)
            if not parts:
                continue
            bk = self.resolve_class(cls_key[0], parts[-1])
            if bk is not None:
                bkey = (bk[0], bk[1], meth)
                if bkey in self.summaries():
                    return bkey
        return None

    def summaries_key(self, cls_key, meth) -> Optional[tuple]:
        key = (cls_key[0], cls_key[1], meth)
        return key if key in self.summaries() else \
            self._self_method(cls_key, meth)

    def _module_function(self, rel, name) -> Optional[tuple]:
        mi = self.modules.get(rel)
        if mi is None:
            return None
        if name in mi.functions:
            return (rel, None, name)
        imp = mi.imports.get(name)
        if imp is not None and imp[1] is not None:
            target = self.by_modname.get(imp[0])
            if target is not None and imp[1] in target.functions:
                return (target.rel, None, imp[1])
        return None

    def _bus_blocking_label(self, rel, call, atypes,
                            local_types) -> Optional[str]:
        """A method call on a receiver typed to a bus/cache class is a
        broker round-trip — blocking by construction."""
        func = call.func
        if not isinstance(func, ast.Attribute):
            return None
        recv = func.value
        fk = None
        attr = _self_attr(recv)
        if attr is not None:
            fk = atypes.get(attr)
        elif isinstance(recv, ast.Name):
            fk = local_types.get(recv.id)
        if fk is None:
            return None
        if any(fk[0].startswith(m) or fk[0] == m
               for m in BUS_MODULE_MARKERS):
            return (f"bus round-trip {self.class_display(fk)}."
                    f"{func.attr}()")
        return None

    # -- transitive closures --

    def locks_closure(self) -> Dict[tuple, Set[str]]:
        """method key -> every qualified lock the method may acquire,
        directly or through resolvable callees. Monotone fixpoint,
        bounded at MAX_FIXPOINT_ROUNDS (beyond that: blind spot, not a
        hang)."""
        if self._locks_closure is not None:
            return self._locks_closure
        summ = self.summaries()
        acq: Dict[tuple, Set[str]] = {}
        via: Dict[tuple, Dict[str, tuple]] = {}
        for key, s in summ.items():
            locks = {lid for lid, _h, _l in s.direct_locks}
            acq[key] = set(locks)
            via[key] = {lid: (None, line)
                        for lid, _h, line in s.direct_locks}
        for _ in range(MAX_FIXPOINT_ROUNDS):
            changed = False
            for key, s in summ.items():
                cur = acq[key]
                for _held, target, line, _label in s.calls:
                    if target is None or target not in acq:
                        continue
                    extra = acq[target] - cur
                    if extra:
                        cur.update(extra)
                        for lid in extra:
                            via[key].setdefault(lid, (target, line))
                        changed = True
            if not changed:
                break
        self._locks_closure = acq
        self._lock_via = via
        return acq

    def lock_chain(self, key: tuple, lock_id: str) -> List[str]:
        """Human-readable frame chain from ``key`` to where ``lock_id``
        is acquired, depth-capped."""
        self.locks_closure()
        chain: List[str] = []
        cur = key
        for _ in range(MAX_CHAIN_DEPTH):
            chain.append(self.describe(cur))
            step = self._lock_via.get(cur, {}).get(lock_id)
            if step is None or step[0] is None:
                break
            cur = step[0]
        return chain

    def blocking_closure(self) -> Dict[tuple, Tuple[str, int, tuple]]:
        """method key -> (blocking label, line, via-callee-or-None):
        the nearest blocking call reachable through the call graph.
        Reverse BFS from directly-blocking methods, depth-capped at
        MAX_CHAIN_DEPTH frames."""
        if self._blocking_closure is not None:
            return self._blocking_closure
        summ = self.summaries()
        callers: Dict[tuple, List[Tuple[tuple, int]]] = {}
        for key, s in summ.items():
            for _held, target, line, _label in s.calls:
                if target is not None:
                    callers.setdefault(target, []).append((key, line))
        out: Dict[tuple, Tuple[str, int, tuple]] = {}
        frontier: List[tuple] = []
        for key, s in summ.items():
            if s.blocking is not None:
                out[key] = (s.blocking[0], s.blocking[1], None)
                frontier.append(key)
        for _ in range(MAX_CHAIN_DEPTH):
            nxt: List[tuple] = []
            for key in frontier:
                for caller, line in callers.get(key, []):
                    if caller in out:
                        continue
                    out[caller] = (out[key][0], line, key)
                    nxt.append(caller)
            if not nxt:
                break
            frontier = nxt
        self._blocking_closure = out
        return out

    def blocking_chain(self, key: tuple) -> List[str]:
        bc = self.blocking_closure()
        chain: List[str] = []
        cur = key
        for _ in range(MAX_CHAIN_DEPTH + 1):
            chain.append(self.describe(cur))
            entry = bc.get(cur)
            if entry is None or entry[2] is None:
                break
            cur = entry[2]
        return chain

    def describe(self, key: tuple) -> str:
        rel, cls, meth = key
        return f"{cls}.{meth}" if cls else meth

    # -- import-time reachability (RTA602) --

    def import_reach(self, roots: Iterable[str]) -> Dict[str, Tuple[str, int]]:
        """rel -> (importer rel, line) for every repo module executed
        at import time when the root modules load, including package
        ``__init__`` chains."""
        reach: Dict[str, Tuple[str, int]] = {}
        frontier: List[str] = []

        def note(rel: str, via: Tuple[str, int]) -> None:
            if rel not in reach:
                reach[rel] = via
                frontier.append(rel)

        for rel in roots:
            if rel in self.modules:
                note(rel, (rel, 0))
                # Importing a.b.c executes a/__init__ and a.b/__init__.
                for pkg_rel in self._pkg_inits(rel):
                    note(pkg_rel, (rel, 0))
        while frontier:
            rel = frontier.pop()
            mi = self.modules[rel]
            for modname, line in mi.import_time:
                target = self._nearest_module(modname)
                if target is None:
                    continue
                note(target.rel, (rel, line))
                for pkg_rel in self._pkg_inits(target.rel):
                    note(pkg_rel, (rel, line))
        return reach

    def _pkg_inits(self, rel: str) -> List[str]:
        out = []
        parts = rel.split("/")[:-1]
        for i in range(1, len(parts) + 1):
            cand = "/".join(parts[:i]) + "/__init__.py"
            if cand in self.modules and cand != rel:
                out.append(cand)
        return out

    def _nearest_module(self, modname: str) -> Optional[ModuleInfo]:
        """``a.b.symbol`` -> the repo module a.b (or a.b.symbol when
        that is itself a module)."""
        while modname:
            mi = self.by_modname.get(modname)
            if mi is not None:
                return mi
            if "." not in modname:
                return None
            modname = modname.rsplit(".", 1)[0]
        return None


class ModuleState:
    """Module-global mutable names + free-function accesses with the
    module-lock held set — :meth:`Program.module_state`."""

    __slots__ = ("candidates", "accesses")

    def __init__(self) -> None:
        self.candidates: Set[str] = set()
        #: (name, held qualified lock ids, function, line, is_write)
        self.accesses: List[Tuple[str, frozenset, str, int, bool]] = []


class _ModuleStateWalker(ast.NodeVisitor):
    """Depth-0 walk of one free function tracking module-lock holds
    (bare ``with _LOCK:`` and dotted ``with mod._LOCK:`` spellings)
    and recording accesses to the module's mutable globals."""

    def __init__(self, locks: Dict[str, str], candidates: Set[str],
                 skip: Set[str], func: str, out: list):
        self.locks = locks
        self.candidates = candidates
        self.skip = skip
        self.func = func
        self.out = out
        self.held: Tuple[str, ...] = ()

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return self.locks.get(expr.id)
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            return self.locks.get(f"{expr.value.id}.{expr.attr}")
        return None

    def visit_With(self, node: ast.With) -> None:
        entered = []
        for item in node.items:
            qid = self._lock_of(item.context_expr)
            if qid is not None:
                entered.append(qid)
            else:
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        prior = self.held
        self.held = tuple(self.held) + tuple(entered)
        for stmt in node.body:
            self.visit(stmt)
        self.held = prior

    def visit_FunctionDef(self, node) -> None:
        pass  # closures run later, inherit nothing — out of scope

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _record(self, name: str, line: int, is_write: bool) -> None:
        self.out.append((name, frozenset(self.held), self.func, line,
                         is_write))

    def visit_Name(self, node: ast.Name) -> None:
        if node.id in self.candidates and node.id not in self.skip:
            self._record(node.id, node.lineno,
                         isinstance(node.ctx, (ast.Store, ast.Del)))

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if isinstance(node.ctx, (ast.Store, ast.Del)) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in self.candidates and \
                node.value.id not in self.skip:
            self._record(node.value.id, node.lineno, True)
            self.visit(node.slice)
            return
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # Container-mutator call on a global is a WRITE of it.
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATORS and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in self.candidates and \
                node.func.value.id not in self.skip:
            self._record(node.func.value.id, node.lineno, True)
        self.generic_visit(node)


class _QualifiedWalker(ast.NodeVisitor):
    """Walks one method filling its :class:`MethodSummary` with
    CLASS-QUALIFIED lock ids: own locks (``with self._cond:``) and
    foreign ones taken through a typed attribute (``with
    self.stats._lock:``) both enter the held set, so cross-class
    ordering edges exist in BOTH directions. ``extra_q`` is the
    caller-holds fixpoint (private method whose every intra-class call
    site holds L), applied at depth 0 only — closures run later and
    inherit nothing."""

    def __init__(self, program: "Program", rel: str, cls_key, info,
                 atypes, summary: MethodSummary, extra_q: frozenset):
        self.program = program
        self.rel = rel
        self.cls_key = cls_key
        self.info = info
        self.atypes = atypes
        self.summary = summary
        self.extra_q = extra_q
        self.held: Tuple[str, ...] = ()
        self.depth = 0
        self._local_types = program._local_types(
            rel, cls_key, summary.node, atypes)
        self._module_locks = program.module_lock_names(rel)

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and attr in self.info.lock_attrs:
            return self.program.lock_id(self.cls_key, attr)
        if isinstance(expr, ast.Name):
            # ``with _LOCK:`` — a module-global primitive (methods and
            # free functions alike reach them by bare name).
            return self._module_locks.get(expr.id)
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name):
                # ``with state._LOCK:`` — a module-global primitive
                # reached through its module (import alias or
                # from-imported module); same qualified id as the bare
                # spelling, so the lock unifies across call styles.
                qid = self._module_locks.get(
                    f"{expr.value.id}.{expr.attr}")
                if qid is not None:
                    return qid
            owner = _self_attr(expr.value)
            fk = self.atypes.get(owner) if owner is not None else None
            if fk is None and isinstance(expr.value, ast.Name):
                fk = self._local_types.get(expr.value.id)
            if fk is not None:
                finfo = self.program._class_info_of(fk)
                if finfo is not None and expr.attr in finfo.lock_attrs:
                    return self.program.lock_id(fk, expr.attr)
        return None

    def _effective(self) -> frozenset:
        held = frozenset(self.held)
        return held if self.depth > 0 else held | self.extra_q

    def visit_With(self, node: ast.With) -> None:
        entered = []
        for item in node.items:
            qid = self._lock_of(item.context_expr)
            if qid is not None:
                entered.append(qid)
                self.summary.direct_locks.append(
                    (qid, self._effective(),
                     item.context_expr.lineno))
            else:
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        prior = self.held
        self.held = tuple(self.held) + tuple(entered)
        for stmt in node.body:
            self.visit(stmt)
        self.held = prior

    def _enter_nested(self, node) -> None:
        prior, self.held = self.held, ()
        self.depth += 1
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.depth -= 1
        self.held = prior

    def visit_FunctionDef(self, node):
        self._enter_nested(node)

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        target, label = self.program._resolve_call(
            self.rel, self.cls_key, node, self.atypes,
            self._local_types)
        self.summary.calls.append(
            (self._effective(), target, node.lineno, label))
        self.summary.call_nodes.append((target, node))
        blabel = _blocking_label(self.info, node)
        if blabel is None:
            blabel = self.program._bus_blocking_label(
                self.rel, node, self.atypes, self._local_types)
        if blabel is not None:
            if self.summary.blocking is None:
                self.summary.blocking = (blabel, node.lineno)
            held = self._effective()
            if held:
                self.summary.held_blocking.append(
                    (held, blabel, node.lineno))
        self.generic_visit(node)


class _FreeContext:
    """Empty class context for module-level functions: the blocking
    predicate needs lock/thread/atomic attr sets to special-case
    ``self.X.wait()`` etc.; free functions have none."""

    lock_attrs: Set[str] = frozenset()
    atomic_attrs: Set[str] = frozenset()
    thread_attrs: Set[str] = frozenset()


_FREE_CONTEXT = _FreeContext()


def _blocking_label(cls, call: ast.Call) -> Optional[str]:
    """The RTA102 blocking predicate, shared by guarded_state (direct,
    intra-method) and the whole-program blocking closure."""
    func = call.func
    if isinstance(func, ast.Name):
        return "open()" if func.id == "open" else None
    if not isinstance(func, ast.Attribute):
        return None
    parts = _dotted(func)
    root, leaf = parts[0], parts[-1]
    if root in BLOCKING_MODULES:
        return ".".join(parts) + "()"
    if root == "time" and leaf == "sleep":
        return "time.sleep()"
    if root == "os" and leaf == "system":
        return "os.system()"
    if root == "shutil" and leaf in ("rmtree", "copytree"):
        return f"shutil.{leaf}()"
    if leaf == "sleep":
        return ".".join(parts) + "()"
    owner = _self_attr(func.value)
    if leaf == "wait":
        # Condition/Lock .wait releases the lock — the idiom, not a
        # bug. Applies to a collaborator's condition too (`with
        # self.owner._cond: self.owner._cond.wait()` — the foreign
        # token that entered the held set). A wait on anything else
        # (Event, future) blocks with the lock held.
        if owner in cls.lock_attrs or \
                _foreign_lock_token(func.value) is not None:
            return None
        return ".".join(parts) + "()"
    if leaf == "join" and owner is not None and \
            owner in cls.thread_attrs:
        return f"self.{owner}.join()"
    if leaf == "result":
        return ".".join(parts) + "()"
    if leaf in ("get", "put") and owner in cls.atomic_attrs:
        return f"self.{owner}.{leaf}()"
    return None
