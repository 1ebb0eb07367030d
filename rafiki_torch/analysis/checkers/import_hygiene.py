"""RTA6xx — import hygiene: what happens when a module is merely
*imported*.

Historical context this encodes (docs/analysis.md): every subprocess
service runner (worker runners, the metrics-only server, docker
children) re-executes module import side effects in ITS process — a
thread started or a socket bound at import time runs once per child,
silently. And the port keeps the reference's lazy-import discipline
for its framework: ``observe/__init__`` loads ``profiling`` (the one
``observe`` module that imports torch) lazily, so a bus broker process
imports no torch.

RTA601: a side effect at import time — statements that execute on a
bare ``import`` (module body through if/try/for/with blocks AND class
bodies; ``if __name__ == "__main__"`` and ``TYPE_CHECKING`` blocks are
exempt):

- a ``Thread(...)`` constructed (or started) at import;
- a socket/server bound (``socket.*``, ``.bind``/``.listen`` on a
  module-level socket, known server constructors);
- a process spawned (``subprocess.*``, ``os.system``);
- an environment variable read (``os.environ.get`` / ``os.getenv`` /
  ``environ[...]``) — the value is frozen at first-import order, which
  is exactly how the NODE_LEASE class-attribute read made apply_env
  ordering matter (fixed by moving it to construction time).

RTA602: an eager (module-level) ``torch`` or ``triton`` import in any
module the bus/broker processes load — computed as the import-time
reachability closure from ``rafiki_torch/bus/*`` over the program's
module graph (package ``__init__`` chains included). A broker that
imports torch pays seconds of import and a CUDA runtime it must never
touch. (The reference's roots are ``jax``, ``jaxlib``, ``flax`` and
``optax``.)
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..core import PKG, Checker, Finding, RepoContext, register
from ..program import _dotted, _toplevel_stmts

_SERVER_CTORS = {"HTTPServer", "ThreadingHTTPServer", "TCPServer",
                 "ThreadingTCPServer", "UDPServer", "JsonHttpServer",
                 "BusServer", "NativeBusServer"}
_TORCH_ROOTS = {"torch", "triton"}

#: Reachability roots: anything a broker/bus process imports first.
_BUS_ROOT_PREFIX = f"{PKG}/bus/"


def _import_time_calls(stmt: ast.AST):
    """Call and Subscript nodes inside ``stmt`` that EXECUTE at
    import time (subscripts carry the ``os.environ["X"]`` reads). The
    bodies of compound statements are yielded separately by
    ``_toplevel_stmts``, so here only the statement's own import-time
    expressions are walked: the whole of a simple statement, the
    test/iter/context of a compound one, and the decorators + default
    arguments of a def (both evaluate at import even though the body
    does not). Function/class/lambda subtrees are never descended
    into."""
    roots: List[ast.AST]
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
        roots = list(stmt.decorator_list) + \
            [d for d in stmt.args.defaults if d is not None] + \
            [d for d in stmt.args.kw_defaults if d is not None]
    elif isinstance(stmt, ast.ClassDef):
        roots = list(stmt.decorator_list) + list(stmt.bases)
    elif isinstance(stmt, (ast.If, ast.While)):
        roots = [stmt.test]
    elif isinstance(stmt, ast.For):
        roots = [stmt.iter]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        roots = [item.context_expr for item in stmt.items]
    elif isinstance(stmt, ast.Try):
        roots = []
    else:
        roots = [stmt]
    stack = list(roots)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, (ast.Call, ast.Subscript)):
            yield node
        stack.extend(ast.iter_child_nodes(node))


@register
class ImportHygieneChecker(Checker):
    name = "import-hygiene"
    codes = ("RTA601", "RTA602")
    scope = "repo"

    def run(self, ctx: RepoContext) -> List[Finding]:
        findings: List[Finding] = []
        for mod in ctx.target_modules():
            if mod.tree is None:
                continue
            findings.extend(self._side_effects(mod.rel, mod.tree))
        findings.extend(self._eager_torch(ctx))
        return findings

    # --- RTA601 ---

    def _side_effects(self, rel: str, tree: ast.AST) -> List[Finding]:
        if rel.endswith("/__main__.py"):
            return []  # entrypoints run on purpose, not on import
        findings: List[Finding] = []
        seen: Set[str] = set()
        thread_names: Set[str] = set()

        def emit(kind: str, detail: str, line: int, what: str,
                 hint: str) -> None:
            anchor = f"import:{kind}:{detail}"
            if anchor in seen:
                return
            seen.add(anchor)
            findings.append(Finding(
                code="RTA601", path=rel, line=line,
                message=f"{what} at import time — every subprocess "
                        f"runner that imports this module re-executes "
                        f"it",
                hint=hint, anchor=anchor))

        for stmt, guarded in _toplevel_stmts(tree):
            if guarded:
                continue
            if isinstance(stmt, ast.Assign) and \
                    isinstance(stmt.value, ast.Call):
                parts = _dotted(stmt.value.func)
                if parts and parts[-1] == "Thread":
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            thread_names.add(tgt.id)
            for node in _import_time_calls(stmt):
                if isinstance(node, ast.Subscript):
                    # os.environ["X"] reads (Load) — the subscript
                    # spelling of the same frozen-at-import hazard.
                    sparts = _dotted(node.value)
                    if sparts and sparts[-1] == "environ" and \
                            isinstance(node.ctx, ast.Load):
                        var = node.slice.value if (
                            isinstance(node.slice, ast.Constant) and
                            isinstance(node.slice.value, str)) else ""
                        emit("env", var or "environ[]", node.lineno,
                             f"environment variable "
                             f"{var or '<dynamic>'} is read",
                             "resolve env at construction/call time "
                             "so apply_env/spawn ordering cannot "
                             "freeze a stale value")
                    continue
                parts = _dotted(node.func)
                if not parts:
                    continue
                root, leaf = parts[0], parts[-1]
                dotted = ".".join(parts)
                if leaf == "Thread" or (leaf == "start"
                                        and root in thread_names):
                    emit("thread", dotted, node.lineno,
                         f"`{dotted}(...)` builds/starts a thread",
                         "create the thread inside a start()/serve() "
                         "call, not at module scope")
                elif (root == "socket" and
                      leaf in ("socket", "create_connection",
                               "create_server")) or \
                        leaf in ("bind", "listen") or \
                        leaf in _SERVER_CTORS:
                    emit("socket", dotted, node.lineno,
                         f"`{dotted}(...)` binds a socket/server",
                         "bind inside an explicit serve()/start() "
                         "entrypoint")
                elif root == "subprocess" or dotted == "os.system":
                    emit("process", dotted, node.lineno,
                         f"`{dotted}(...)` spawns a process",
                         "spawn from a function the caller invokes "
                         "deliberately")
                elif (var := self._env_read(node)) is not None:
                    emit("env", var or dotted, node.lineno,
                         f"environment variable "
                         f"{var or '<dynamic>'} is read",
                         "resolve env at construction/call time (a "
                         "NodeConfig field, or a read inside the "
                         "function that needs it) so apply_env/spawn "
                         "ordering cannot freeze a stale value")
        return findings

    @staticmethod
    def _env_read(node: ast.Call) -> Optional[str]:
        """'VAR' (or "" for a dynamic name) when this call reads the
        environment; None otherwise."""
        parts = _dotted(node.func)
        dotted = ".".join(parts)
        is_env = dotted in ("os.getenv", "getenv") or (
            len(parts) >= 2 and parts[-2] == "environ" and
            parts[-1] in ("get", "pop"))
        if not is_env:
            return None
        if node.args and isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            return node.args[0].value
        return ""

    # --- RTA602 ---

    def _eager_torch(self, ctx: RepoContext) -> List[Finding]:
        program = ctx.program()
        roots = [rel for rel in program.modules
                 if rel.startswith(_BUS_ROOT_PREFIX)]
        if not roots:
            return []
        reach = program.import_reach(roots)
        findings: List[Finding] = []
        for rel in sorted(reach):
            mi = program.modules[rel]
            for modname, line in mi.import_time:
                top = modname.split(".")[0]
                if top not in _TORCH_ROOTS:
                    continue
                chain = self._chain(program, reach, rel)
                findings.append(Finding(
                    code="RTA602", path=rel, line=line,
                    message=f"eager `{modname}` import in a module the "
                            f"bus/broker processes load "
                            f"(import chain: {' -> '.join(chain)})",
                    hint="move the import inside the function that "
                         "needs it (the observe/__init__ lazy-symbol "
                         "pattern), or break the module edge from the "
                         "bus path",
                    anchor=f"eager-torch:{modname}"))
                break  # one finding per module is enough
        return findings

    @staticmethod
    def _chain(program, reach, rel: str) -> List[str]:
        chain = [rel]
        cur = rel
        for _ in range(12):
            via = reach.get(cur)
            if via is None or via[0] == cur:
                break
            cur = via[0]
            chain.append(cur)
        return list(reversed(chain))
