"""RTA7xx — flow: conformance of the distributed seams.

The RTA1xx/5xx families check what one process does with its own state.
This family checks the seams BETWEEN processes, where nothing in the
type system or the test suite connects producer to consumer:

- **RTA701 — bus queue-flow drift.** The bus is stringly-typed: a
  worker pops ``f"q:{worker_id}"`` because the cache pushes the same
  spelling. The checker harvests the queue-name vocabulary at every
  push/pop site (string literals and f-string *prefixes*, resolved
  through the call graph so a helper forwarding a ``queue`` argument
  attributes the name to the real producer/consumer), groups names
  into families by their ``prefix:`` segment, and flags a family
  pushed with no popper (orphan producer) or popped with no pusher
  (dead consumer). Control-frame op tokens (the ``__restack__`` style
  dunder strings) are checked producer vs dispatcher the same way.
- **RTA702 — HTTP route drift.** Server-side registered method+path
  tuples (predictor/admin apps, the ``utils/service.py`` route table)
  vs every in-tree caller: the client SDK's ``_call`` (and the port's
  ``_send`` of a whole ``f"{self._base}/path"`` URL), autoscaler/SLO
  ``fetch`` scrapes, cluster peer probes (``urlopen``/``Request``),
  session-based uploads, and the dashboard's ``api(...)`` calls. A
  caller hitting an unregistered route flags; a served route with zero
  in-tree callers flags too (waivable for operator-only surfaces).
- **RTA703 — feature-flag off-path side effects.** For declared
  default-off flags (``FLAG_REGISTRY``; seeded with
  ``RAFIKI_TPU_CLUSTER_FABRIC``), any thread spawn, metric-series
  registration, bus subscription loop, or socket open reachable from
  import or construction *without* passing the flag gate flags. The
  gate vocabulary is the env-var name, its NodeConfig field, a call of
  the flag's predicate (the port's ``cluster_fabric_enabled()``), and
  attributes whose every truthy assignment is flag-gated (so
  ``if self._fabric:`` counts as a gate); functions whose every
  resolvable call site is gated (or whose class is only constructed
  under the gate) are *protected* and audited as on-path.

Resolution rules (documented blind spots in docs/analysis.md):

- f-string queue names resolve to their literal prefix up to the first
  placeholder; an empty prefix is dynamic and exempt.
- a ``Name`` queue argument resolves through local assignment, then
  through the call graph (bounded depth) when it is a parameter; a
  ``Call`` argument resolves when the callee's every return value
  resolves (the ``_req_queue(sub_id)`` helper shape).
- gate polarity is not tracked: ``if not flag: return`` gates the rest
  of the function (correct), but an inverted guard would too.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core import PKG, Checker, Finding, RepoContext, register
from ..program import _dotted, _self_attr

PUSH_OPS = frozenset({"push", "push_many", "relay_push",
                      "relay_push_many"})
POP_OPS = frozenset({"pop", "pop_all", "queue_len", "delete_queue"})
QUEUE_OPS = PUSH_OPS | POP_OPS
HTTP_VERBS = frozenset({"GET", "POST", "PUT", "DELETE", "PATCH"})
OP_TOKEN_RE = re.compile(r"^__\w+__$")
#: Modules implementing the bus itself — their push/pop are the
#: generic transport, not a named producer/consumer.
BUS_IMPL_PREFIX = f"{PKG}/bus/"
#: Bound on queue-name resolution through forwarding helpers.
MAX_FORWARD = 3

#: RTA703's declared default-off feature flags. Each entry names the
#: env gate, its NodeConfig field (both spellings are gate vocabulary),
#: the modules the flag wholly owns, and the metric-series prefixes
#: that must never register off-path. Extending this registry is the
#: documented procedure for every new default-off subsystem
#: (docs/analysis.md).
FLAG_REGISTRY: Tuple[Dict[str, object], ...] = (
    {
        "flag": "RAFIKI_TPU_CLUSTER_FABRIC",
        "field": "cluster_fabric",
        # The port reads the flag through one predicate
        # (``config.cluster_fabric_enabled``); a call of it is a gate.
        "predicates": ("cluster_fabric_enabled",),
        "owned_modules": (f"{PKG}/admin/nodes.py",),
        # Deliberately narrower than rafiki_tpu_node_*: the
        # supervisor's rafiki_tpu_node_restarts_total predates the
        # fabric and lives on the always-on path.
        "owned_series": ("rafiki_tpu_node_peers",
                         "rafiki_tpu_serving_fabric_"),
    },
)

SERIES_FACTORIES = frozenset({"counter", "gauge", "histogram"})


class _Ctx:
    """One function/method with everything needed to resolve calls and
    receiver types at its sites."""

    __slots__ = ("rel", "cls_key", "fname", "node", "atypes", "ltypes",
                 "key")

    def __init__(self, key, node, atypes, ltypes):
        self.key = key
        self.rel = key[0]
        self.cls_key = (key[0], key[1]) if key[1] else None
        self.fname = key[2]
        self.node = node
        self.atypes = atypes
        self.ltypes = ltypes


def _leaf(func) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _recv_name(expr) -> Optional[str]:
    attr = _self_attr(expr)
    if attr is not None:
        return attr
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _first_assign(fnode, name: str):
    for n in ast.walk(fnode):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and n.targets[0].id == name:
            return n.value
    return None


def _fstr_prefix(node: ast.JoinedStr) -> str:
    """Literal prefix of an f-string up to the first placeholder."""
    prefix = ""
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            prefix += v.value
        else:
            break
    return prefix


def _family(name: str, is_prefix: bool) -> Optional[str]:
    """Queue-name family: through the first ``:`` inclusive, else the
    whole literal name. A *prefix* with no ``:`` yet is incomplete —
    dynamic, exempt."""
    i = name.find(":")
    if i >= 0:
        return name[:i + 1]
    return None if is_prefix else name


def _queue_arg(op: str, call: ast.Call):
    """The queue-name expression of a bus queue op, or None when the
    op embeds names in item tuples (push_many)."""
    for kw in call.keywords:
        if kw.arg == "queue":
            return kw.value
    if op in ("push_many", "relay_push_many"):
        return None
    idx = 1 if op == "relay_push" else 0
    if len(call.args) > idx:
        return call.args[idx]
    return None


def _segs(path: str) -> List[str]:
    """Normalized path segments: query stripped, ``<param>``/dynamic
    segments become the wildcard ``*``."""
    path = path.split("?", 1)[0]
    out = []
    for s in path.split("/"):
        if not s:
            continue
        if s.startswith("<") or "*" in s or "${" in s:
            out.append("*")
        else:
            out.append(s)
    return out


def _seg_match(a: Sequence[str], b: Sequence[str]) -> bool:
    return len(a) == len(b) and all(
        x == y or x == "*" or y == "*" for x, y in zip(a, b))


@register
class FlowChecker(Checker):
    name = "flow"
    codes = ("RTA701", "RTA702", "RTA703")
    scope = "repo"

    def run(self, ctx: RepoContext) -> List[Finding]:
        program = ctx.program()
        by_key: Dict[tuple, _Ctx] = {}
        contexts: List[_Ctx] = []
        for key, s in program.summaries().items():
            cls_key = (key[0], key[1]) if key[1] else None
            atypes = program.attr_types(cls_key) if cls_key else {}
            ltypes = program._local_types(key[0], cls_key, s.node,
                                          atypes)
            c = _Ctx(key, s.node, atypes, ltypes)
            by_key[key] = c
            contexts.append(c)
        # Cross-process call index: target -> [(caller key, Call)],
        # straight off the summaries' resolved call_nodes.
        call_index: Dict[tuple, List[Tuple[tuple, ast.Call]]] = {}
        for key, s in program.summaries().items():
            for tgt, call in s.call_nodes:
                if tgt is not None:
                    call_index.setdefault(tgt, []).append((key, call))

        findings: List[Finding] = []
        findings.extend(self._queue_flow(program, contexts, by_key,
                                         call_index))
        findings.extend(self._route_drift(ctx, program, contexts))
        findings.extend(self._flag_offpath(program, contexts, by_key,
                                           call_index))
        return findings

    # ------------------------------------------------------------------
    # RTA701 — bus queue-flow
    # ------------------------------------------------------------------

    def _bus_receiver(self, c: _Ctx, recv) -> bool:
        attr = _self_attr(recv)
        if attr is not None:
            fk = c.atypes.get(attr)
        elif isinstance(recv, ast.Name) and recv.id != "self":
            fk = c.ltypes.get(recv.id)
        else:
            fk = None
        return fk is not None and fk[0].startswith(BUS_IMPL_PREFIX)

    def _queue_families(self, program, c: _Ctx, expr, depth: int,
                        seen: set, by_key, call_index) -> Set[str]:
        if depth < 0 or expr is None:
            return set()
        if isinstance(expr, ast.Constant) and isinstance(expr.value,
                                                         str):
            f = _family(expr.value, False)
            return {f} if f else set()
        if isinstance(expr, ast.JoinedStr):
            p = _fstr_prefix(expr)
            f = _family(p, True) if p else None
            return {f} if f else set()
        if isinstance(expr, ast.Name):
            params = {a.arg for a in (c.node.args.args
                                      + c.node.args.kwonlyargs)}
            if expr.id in params:
                return self._param_families(program, c, expr.id, depth,
                                            seen, by_key, call_index)
            a = _first_assign(c.node, expr.id)
            if a is not None:
                return self._queue_families(program, c, a, depth - 1,
                                            seen, by_key, call_index)
            return set()
        if isinstance(expr, ast.Call):
            tgt, _label = program._resolve_call(c.rel, c.cls_key, expr,
                                                c.atypes, c.ltypes)
            tctx = by_key.get(tgt) if tgt is not None else None
            if tctx is None:
                return set()
            fams: Set[str] = set()
            for n in ast.walk(tctx.node):
                if isinstance(n, ast.Return) and n.value is not None:
                    fams |= self._queue_families(
                        program, tctx, n.value, depth - 1, seen,
                        by_key, call_index)
            return fams
        return set()

    def _param_families(self, program, c: _Ctx, pname: str, depth: int,
                        seen: set, by_key, call_index) -> Set[str]:
        """A queue name that is a *parameter* of the enclosing helper:
        resolve it at every resolvable call site, attributing the name
        to the real producer/consumer behind the forwarder."""
        mark = (c.key, pname)
        if mark in seen or depth <= 0:
            return set()
        seen.add(mark)
        names = [a.arg for a in c.node.args.args]
        offset = 1 if (c.cls_key is not None and names
                       and names[0] == "self") else 0
        fams: Set[str] = set()
        for caller_key, call in call_index.get(c.key, ()):
            cc = by_key.get(caller_key)
            if cc is None:
                continue
            aexpr = None
            if pname in names:
                pi = names.index(pname) - offset
                if 0 <= pi < len(call.args):
                    aexpr = call.args[pi]
            for kw in call.keywords:
                if kw.arg == pname:
                    aexpr = kw.value
            if aexpr is not None:
                fams |= self._queue_families(program, cc, aexpr,
                                             depth - 1, seen, by_key,
                                             call_index)
        return fams

    def _tuple_families(self, c: _Ctx) -> Set[str]:
        """push_many embeds ``(queue, value)`` tuples in its items
        argument, usually built earlier in the function — scan the
        enclosing function for 2-tuples with a resolvable first
        element."""
        fams: Set[str] = set()
        for n in ast.walk(c.node):
            if isinstance(n, ast.Tuple) and len(n.elts) == 2:
                e0 = n.elts[0]
                if isinstance(e0, ast.Constant) and isinstance(
                        e0.value, str):
                    f = _family(e0.value, False)
                elif isinstance(e0, ast.JoinedStr):
                    p = _fstr_prefix(e0)
                    f = _family(p, True) if p else None
                else:
                    f = None
                if f:
                    fams.add(f)
        return fams

    def _queue_flow(self, program, contexts, by_key,
                    call_index) -> List[Finding]:
        sites: Dict[str, Dict[str, List[Tuple[str, int]]]] = {}
        busy: Set[str] = set()
        push_calls: List[Tuple[_Ctx, ast.Call]] = []
        pop_calls: List[Tuple[_Ctx, ast.Call]] = []
        for c in contexts:
            if c.rel.startswith(BUS_IMPL_PREFIX):
                continue
            for node in ast.walk(c.node):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                op = node.func.attr
                if op not in QUEUE_OPS:
                    continue
                if not self._bus_receiver(c, node.func.value):
                    continue
                busy.add(c.rel)
                kind = "push" if op in PUSH_OPS else "pop"
                (push_calls if kind == "push"
                 else pop_calls).append((c, node))
                qexpr = _queue_arg(op, node)
                if qexpr is not None:
                    fams = self._queue_families(
                        program, c, qexpr, MAX_FORWARD, set(), by_key,
                        call_index)
                else:
                    fams = self._tuple_families(c)
                for fam in fams:
                    sites.setdefault(fam, {}).setdefault(
                        kind, []).append((c.rel, node.lineno))

        findings: List[Finding] = []
        for fam in sorted(sites):
            pushes = sites[fam].get("push", [])
            pops = sites[fam].get("pop", [])
            if pushes and not pops:
                rel, line = pushes[0]
                findings.append(Finding(
                    code="RTA701", path=rel, line=line,
                    message=f"queue family '{fam}' is pushed here but "
                            f"no in-tree consumer ever pops it "
                            f"(orphan producer)",
                    hint="point a consumer at this queue name, or fix "
                         "the producer-side spelling; f-string names "
                         "resolve by literal prefix",
                    anchor=f"queue:{fam}"))
            elif pops and not pushes:
                rel, line = pops[0]
                findings.append(Finding(
                    code="RTA701", path=rel, line=line,
                    message=f"queue family '{fam}' is popped here but "
                            f"no in-tree producer ever pushes it "
                            f"(dead consumer)",
                    hint="wire a producer, or delete the consumer "
                         "loop; f-string names resolve by literal "
                         "prefix",
                    anchor=f"queue:{fam}"))
        findings.extend(self._op_tokens(program, busy, push_calls,
                                        pop_calls, contexts))
        return findings

    def _op_tokens(self, program, busy: Set[str], push_calls,
                   pop_calls, contexts) -> List[Finding]:
        """Control-frame op tokens (``__drain__``-style dunder strings
        defined next to bus queue ops): every token needs both a
        producer (pushed inside a bus push op) and a dispatcher (a
        membership/equality test, subscript, or dict-pop on the
        token)."""
        token_defs: Dict[str, Tuple[str, str, int]] = {}
        for rel in sorted(busy):
            mi = program.modules.get(rel)
            if mi is None or mi.tree is None:
                continue
            for stmt in mi.tree.body:
                if isinstance(stmt, ast.Assign) \
                        and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and isinstance(stmt.value, ast.Constant) \
                        and isinstance(stmt.value.value, str) \
                        and OP_TOKEN_RE.match(stmt.value.value):
                    token_defs.setdefault(
                        stmt.value.value,
                        (rel, stmt.targets[0].id, stmt.lineno))
        if not token_defs:
            return []
        by_def = {(program.modules[rel].modname, name): value
                  for value, (rel, name, _l) in token_defs.items()}

        def names_for(rel: str) -> Dict[str, str]:
            out = {name: value
                   for value, (drel, name, _l) in token_defs.items()
                   if drel == rel}
            mi = program.modules.get(rel)
            if mi is not None:
                for local, (modname, symbol) in mi.imports.items():
                    if symbol is not None \
                            and (modname, symbol) in by_def:
                        out[local] = by_def[(modname, symbol)]
            return out

        def refs(expr, names: Dict[str, str]) -> Set[str]:
            out: Set[str] = set()
            if isinstance(expr, ast.Name) and expr.id in names:
                out.add(names[expr.id])
            elif isinstance(expr, ast.Constant) \
                    and expr.value in token_defs:
                out.add(expr.value)
            return out

        produced: Set[str] = set()
        for c, call in push_calls:
            names = names_for(c.rel)
            for arg in list(call.args) + [kw.value
                                          for kw in call.keywords]:
                for n in ast.walk(arg):
                    produced |= refs(n, names)
        dispatched: Set[str] = set()
        for c in contexts:
            if c.rel.startswith(BUS_IMPL_PREFIX):
                continue
            names = names_for(c.rel)
            if not names:
                continue
            for n in ast.walk(c.node):
                if isinstance(n, ast.Compare) and any(
                        isinstance(op, (ast.In, ast.NotIn, ast.Eq,
                                        ast.NotEq)) for op in n.ops):
                    for side in [n.left] + list(n.comparators):
                        dispatched |= refs(side, names)
                elif isinstance(n, ast.Subscript):
                    dispatched |= refs(n.slice, names)
                elif isinstance(n, ast.Call) \
                        and _leaf(n.func) in ("pop", "get") \
                        and n.args:
                    dispatched |= refs(n.args[0], names)

        findings: List[Finding] = []
        for value in sorted(token_defs):
            rel, name, line = token_defs[value]
            if value in produced and value not in dispatched:
                findings.append(Finding(
                    code="RTA701", path=rel, line=line,
                    message=f"control token {name} ({value}) is "
                            f"pushed onto the bus but no dispatcher "
                            f"ever checks for it",
                    hint="add the token to the consumer's dispatch "
                         "(membership test / dict pop), or delete "
                         "the producer",
                    anchor=f"op-token:{value}"))
            elif value in dispatched and value not in produced:
                findings.append(Finding(
                    code="RTA701", path=rel, line=line,
                    message=f"control token {name} ({value}) is "
                            f"dispatched on but never pushed by any "
                            f"in-tree producer",
                    hint="wire the producer, or delete the dead "
                         "dispatch arm",
                    anchor=f"op-token:{value}"))
        return findings

    # ------------------------------------------------------------------
    # RTA702 — HTTP route drift
    # ------------------------------------------------------------------

    def _path_str(self, c: _Ctx, expr, depth: int) -> Optional[str]:
        if depth < 0 or expr is None:
            return None
        if isinstance(expr, ast.Constant) and isinstance(expr.value,
                                                         str):
            return expr.value
        if isinstance(expr, ast.JoinedStr):
            return "".join(
                str(v.value) if isinstance(v, ast.Constant) else "*"
                for v in expr.values)
        if isinstance(expr, ast.Name):
            a = _first_assign(c.node, expr.id)
            return self._path_str(c, a, depth - 1)
        if isinstance(expr, ast.BinOp) and isinstance(expr.op,
                                                      ast.Add):
            return self._path_str(c, expr.left, depth - 1)
        if isinstance(expr, ast.IfExp):
            return self._path_str(c, expr.body, depth - 1)
        return None

    def _call_sites(self, c: _Ctx,
                    node: ast.Call) -> List[Tuple[str, str]]:
        func = node.func
        leaf = _leaf(func)
        out: List[Tuple[str, str]] = []
        if leaf in ("_call", "_send") and len(node.args) >= 2 \
                and isinstance(node.args[0], ast.Constant) \
                and str(node.args[0].value).upper() in HTTP_VERBS:
            p = self._path_str(c, node.args[1], 2)
            if p and leaf == "_send" and p.startswith("*/"):
                # The port's client sends whole URLs,
                # f"{self._base}/path": the base is the placeholder.
                p = p[1:]
            if p and p.startswith("/"):
                out.append((str(node.args[0].value).upper(), p))
        elif leaf in ("urlopen", "Request"):
            url = node.args[0] if node.args else None
            s = self._path_str(c, url, 1)
            if s and (s.startswith("http://")
                      or s.startswith("https://")):
                rest = s.split("://", 1)[1]
                i = rest.find("/")
                if i >= 0:
                    method = "GET"
                    if leaf == "Request" and len(node.args) >= 2:
                        method = "POST"  # positional data payload
                    for kw in node.keywords:
                        if kw.arg == "method" and isinstance(
                                kw.value, ast.Constant):
                            method = str(kw.value.value).upper()
                        elif kw.arg == "data" and method == "GET":
                            method = "POST"
                    out.append((method, rest[i:]))
        elif leaf in ("fetch", "fetch_endpoint"):
            for a in node.args[:2]:
                if isinstance(a, ast.Constant) \
                        and isinstance(a.value, str) \
                        and a.value.startswith("/"):
                    out.append(("GET", a.value))
                    break
        elif leaf in ("get", "post", "put", "delete") \
                and isinstance(func, ast.Attribute):
            rname = _recv_name(func.value)
            if rname and "session" in rname and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.BinOp) \
                        and isinstance(a0.op, ast.Add):
                    p = self._path_str(c, a0.right, 1)
                    if p and p.startswith("/"):
                        out.append((leaf.upper(), p))
        return out

    def _html_calls(self, root: str) -> List[Tuple[str, str, str, int]]:
        """Dashboard ``api("VERB", "/path")`` calls (string and
        template-literal forms; ``${...}`` becomes a wildcard)."""
        out: List[Tuple[str, str, str, int]] = []
        web = pathlib.Path(root) / PKG / "web"
        if not web.is_dir():
            return out
        pat = re.compile(
            r'api\(\s*"(GET|POST|PUT|DELETE|PATCH)"\s*,\s*'
            r'(?:"([^"]*)"|`([^`]*)`)')
        for path in sorted(web.glob("*.html")):
            try:
                text = path.read_text(encoding="utf-8",
                                      errors="replace")
            except OSError:
                continue
            rel = path.relative_to(root).as_posix()
            for m in pat.finditer(text):
                raw = m.group(2) if m.group(2) is not None \
                    else m.group(3)
                raw = re.sub(r"\$\{[^}]*\}", "*", raw)
                line = text.count("\n", 0, m.start()) + 1
                out.append((m.group(1), raw, rel, line))
        return out

    def _route_drift(self, ctx: RepoContext, program,
                     contexts) -> List[Finding]:
        served: List[Tuple[str, str, str, int]] = []
        for mi in program.modules.values():
            if mi.tree is None:
                continue
            for node in ast.walk(mi.tree):
                if isinstance(node, (ast.Tuple, ast.List)) \
                        and len(node.elts) == 3:
                    e0, e1 = node.elts[0], node.elts[1]
                    if isinstance(e0, ast.Constant) \
                            and isinstance(e0.value, str) \
                            and e0.value.upper() in HTTP_VERBS \
                            and isinstance(e1, ast.Constant) \
                            and isinstance(e1.value, str) \
                            and e1.value.startswith("/"):
                        served.append((e0.value.upper(), e1.value,
                                       mi.rel, node.lineno))
        callers: List[Tuple[str, str, str, int]] = []
        for c in contexts:
            for node in ast.walk(c.node):
                if isinstance(node, ast.Call):
                    for m, p in self._call_sites(c, node):
                        callers.append((m, p, c.rel, node.lineno))
        callers.extend(self._html_calls(ctx.root))

        served_norm = [(m, _segs(p), p, rel, line)
                       for m, p, rel, line in served]
        matched = [False] * len(served_norm)
        findings: List[Finding] = []
        seen: Set[Tuple[str, str]] = set()
        for m, p, rel, line in callers:
            segs = _segs(p)
            hit = False
            for i, (sm, ssegs, _sp, _srel, _sl) in enumerate(
                    served_norm):
                if sm == m and _seg_match(segs, ssegs):
                    matched[i] = True
                    hit = True
            if not hit:
                disp = "/" + "/".join(segs)
                if (m, disp) in seen:
                    continue
                seen.add((m, disp))
                findings.append(Finding(
                    code="RTA702", path=rel, line=line,
                    message=f"HTTP call {m} {disp} matches no served "
                            f"route",
                    hint="fix the path/method to a registered route, "
                         "or register the route server-side",
                    anchor=f"route-call:{m} {disp}"))
        for i, (sm, _ssegs, sp, srel, sline) in enumerate(served_norm):
            if matched[i]:
                continue
            findings.append(Finding(
                code="RTA702", path=srel, line=sline,
                message=f"served route {sm} {sp} has no in-tree "
                        f"caller",
                hint="wire a caller (client SDK / dashboard / "
                     "scraper), or waive as an operator-only surface",
                anchor=f"route:{sm} {sp}"))
        return findings

    # ------------------------------------------------------------------
    # RTA703 — feature-flag off-path side effects
    # ------------------------------------------------------------------

    def _node_effects(self, fnode) -> List[Tuple[str, str, ast.AST]]:
        out: List[Tuple[str, str, ast.AST]] = []
        for n in ast.walk(fnode):
            if isinstance(n, ast.Call):
                leaf = _leaf(n.func)
                if leaf == "Thread":
                    out.append(("thread", "Thread()", n))
                elif leaf in SERIES_FACTORIES \
                        and isinstance(n.func, ast.Attribute):
                    recv = n.func.value
                    rleaf = _leaf(recv.func) if isinstance(
                        recv, ast.Call) else None
                    if rleaf == "registry":
                        name = ""
                        if n.args and isinstance(n.args[0],
                                                 ast.Constant):
                            name = str(n.args[0].value)
                        out.append(("series", name, n))
                elif leaf in ("socket", "create_connection"):
                    parts = _dotted(n.func)
                    if parts and parts[0] == "socket":
                        out.append(("socket",
                                    ".".join(parts) + "()", n))
                elif leaf == "urlopen":
                    out.append(("socket", "urlopen()", n))
            elif isinstance(n, ast.While):
                for sub in ast.walk(n):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr in ("pop", "pop_all"):
                        rn = _recv_name(sub.func.value)
                        if rn and "bus" in rn:
                            out.append((
                                "bus-loop",
                                f"subscription loop "
                                f"({sub.func.attr}())", n))
                            break
        return out

    @staticmethod
    def _gated_nodes(fnode, test) -> Set[int]:
        """ids of AST nodes only reachable under a gate the vocabulary
        test accepts. ``if <gate>: return`` gates the statements after
        it (the early-return shape); polarity is not tracked."""
        gated: Set[int] = set()

        def mark(n):
            for sub in ast.walk(n):
                gated.add(id(sub))

        def walk(stmts, gate: bool):
            for i, st in enumerate(stmts):
                if gate:
                    mark(st)
                    continue
                if isinstance(st, ast.If):
                    t = test(st.test)
                    walk(st.body, t)
                    walk(st.orelse, False)
                    if t and st.body and all(
                            isinstance(x, (ast.Return, ast.Raise,
                                           ast.Break, ast.Continue))
                            for x in st.body):
                        walk(list(stmts[i + 1:]), True)
                elif isinstance(st, ast.While):
                    walk(st.body, test(st.test))
                    walk(st.orelse, False)
                elif isinstance(st, (ast.For, ast.AsyncFor)):
                    walk(st.body, False)
                    walk(st.orelse, False)
                elif isinstance(st, ast.Try):
                    walk(st.body, False)
                    for h in st.handlers:
                        walk(h.body, False)
                    walk(st.orelse, False)
                    walk(st.finalbody, False)
                elif isinstance(st, (ast.With, ast.AsyncWith)):
                    walk(st.body, False)
                elif isinstance(st, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    walk(st.body, False)

        walk(fnode.body, False)
        for n in ast.walk(fnode):
            if isinstance(n, ast.IfExp) and test(n.test):
                mark(n.body)
        return gated

    def _flag_offpath(self, program, contexts, by_key,
                      call_index) -> List[Finding]:
        findings: List[Finding] = []
        for spec in FLAG_REGISTRY:
            findings.extend(self._audit_flag(spec, program, contexts,
                                             by_key, call_index))
        return findings

    def _audit_flag(self, spec, program, contexts, by_key,
                    call_index) -> List[Finding]:
        flag = spec["flag"]
        field = spec["field"]
        owned = set(spec["owned_modules"])
        series_prefixes = tuple(spec["owned_series"])
        predicates = set(spec.get("predicates", ()))

        def base_vocab(expr) -> bool:
            for n in ast.walk(expr):
                if isinstance(n, ast.Constant) \
                        and n.value in (flag, field):
                    return True
                if isinstance(n, ast.Attribute) and n.attr == field:
                    return True
                if isinstance(n, ast.Call) \
                        and _leaf(n.func) in predicates:
                    return True
            return False

        # One walk of each function: the vocabulary it could hold, and
        # its attribute assignments. A function that names none of the
        # vocabulary gates nothing, so its gated set is empty without
        # the statement walk (the cost of this pass is in those walks).
        attrs_of: Dict[tuple, Set[str]] = {}
        has_base: Set[tuple] = set()
        attr_sets: Dict[tuple, List[Tuple[str, ast.AST, ast.AST]]] = {}
        for c in contexts:
            attrs: Set[str] = set()
            base = False
            sets: List[Tuple[str, ast.AST, ast.AST]] = []
            for n in ast.walk(c.node):
                if isinstance(n, ast.Attribute):
                    attrs.add(n.attr)
                elif isinstance(n, ast.Constant):
                    base = base or n.value in (flag, field)
                elif isinstance(n, ast.Call):
                    base = base or _leaf(n.func) in predicates
                if isinstance(n, ast.Assign) \
                        and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Attribute):
                    sets.append((n.targets[0].attr, n.value, n))
                elif isinstance(n, ast.AnnAssign) \
                        and isinstance(n.target, ast.Attribute) \
                        and n.value is not None:
                    sets.append((n.target.attr, n.value, n))
            attrs_of[c.key] = attrs
            attr_sets[c.key] = sets
            if base or field in attrs:
                has_base.add(c.key)

        # Pass A: per-function locals bound from base vocabulary
        # (``cluster_on = _parse_bool(env(...cluster_fabric...))``).
        base_locals: Dict[tuple, Set[str]] = {}
        for c in contexts:
            if c.key not in has_base:
                continue
            locs: Set[str] = set()
            for n in ast.walk(c.node):
                if isinstance(n, ast.Assign) \
                        and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and base_vocab(n.value):
                    locs.add(n.targets[0].id)
            if locs:
                base_locals[c.key] = locs

        def vocab_a(c: _Ctx):
            locs = base_locals.get(c.key, set())

            def test(expr) -> bool:
                if base_vocab(expr):
                    return True
                return any(isinstance(n, ast.Name) and n.id in locs
                           for n in ast.walk(expr))
            return test

        gated_cache_a: Dict[tuple, Set[int]] = {}

        def gated_a(c: _Ctx) -> Set[int]:
            g = gated_cache_a.get(c.key)
            if g is None:
                g = self._gated_nodes(c.node, vocab_a(c)) \
                    if c.key in has_base else set()
                gated_cache_a[c.key] = g
            return g

        # Gate attributes: every truthy assignment is flag-gated or
        # flag-derived, so testing the attribute IS testing the flag.
        attr_assigns: Dict[str, List[Tuple[bool, bool]]] = {}
        for c in contexts:
            if not attr_sets[c.key]:
                continue
            test = vocab_a(c)
            g = gated_a(c)
            for attr, val, n in attr_sets[c.key]:
                truthy = not (isinstance(val, ast.Constant)
                              and (val.value is None
                                   or val.value is False))
                ok = (id(n) in g) or test(val)
                attr_assigns.setdefault(attr, []).append((truthy, ok))
        gate_attrs = {a for a, lst in attr_assigns.items()
                      if any(t for t, _ in lst)
                      and all(ok for t, ok in lst if t)}

        def vocab_b(c: _Ctx):
            locs = set(base_locals.get(c.key, set()))

            def contains(expr) -> bool:
                for n in ast.walk(expr):
                    if isinstance(n, ast.Constant) \
                            and n.value in (flag, field):
                        return True
                    if isinstance(n, ast.Attribute) \
                            and (n.attr == field
                                 or n.attr in gate_attrs):
                        return True
                    if isinstance(n, ast.Name) and n.id in locs:
                        return True
                    if isinstance(n, ast.Call) \
                            and _leaf(n.func) in predicates:
                        return True
                return False

            for n in ast.walk(c.node):
                if isinstance(n, ast.Assign) \
                        and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and contains(n.value):
                    locs.add(n.targets[0].id)
            return contains

        gated_cache: Dict[tuple, Set[int]] = {}

        def gated(key: tuple) -> Set[int]:
            g = gated_cache.get(key)
            if g is None:
                c = by_key[key]
                g = self._gated_nodes(c.node, vocab_b(c)) \
                    if key in has_base or attrs_of[key] & gate_attrs \
                    else set()
                gated_cache[key] = g
            return g

        # Constructor sites of every resolvable class (Name-call form).
        ctor_sites: Dict[tuple, List[Tuple[tuple, ast.Call]]] = {}
        for c in contexts:
            for n in ast.walk(c.node):
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Name):
                    ck = program.resolve_class(c.rel, n.func.id)
                    if ck is not None:
                        ctor_sites.setdefault(ck, []).append(
                            (c.key, n))

        # Protected fixpoint: methods of construction-gated classes,
        # plus functions whose every resolvable call site is gated or
        # made from protected code.
        protected: Set[tuple] = set()
        methods_of: Dict[tuple, List[tuple]] = {}
        for key in by_key:
            if key[1] is not None:
                methods_of.setdefault((key[0], key[1]),
                                      []).append(key)
        for _round in range(10):
            changed = False
            for ck, csites in ctor_sites.items():
                if all(id(n) in gated(k) or k in protected
                       for k, n in csites):
                    for mkey in methods_of.get(ck, ()):
                        if mkey not in protected:
                            protected.add(mkey)
                            changed = True
            for fkey, fsites in call_index.items():
                if fkey in protected or fkey not in by_key:
                    continue
                if fsites and all(id(n) in gated(k) or k in protected
                                  for k, n in fsites):
                    protected.add(fkey)
                    changed = True
            if not changed:
                break

        findings: List[Finding] = []

        def disp(key: tuple) -> str:
            return f"{key[1]}.{key[2]}" if key[1] else key[2]

        # V1: ungated import-time effects in an owned module.
        for rel in sorted(owned & set(program.modules)):
            mi = program.modules[rel]
            if mi.tree is None:
                continue
            for gate, kind, label, n in self._import_effects(
                    mi.tree, base_vocab):
                if not gate:
                    findings.append(Finding(
                        code="RTA703", path=rel, line=n.lineno,
                        message=f"{label} runs at import time of "
                                f"{rel}, which {flag} (default off) "
                                f"owns — the off path pays for it",
                        hint=f"move the effect behind the {flag} "
                             f"gate (lazy construction)",
                        anchor=f"{flag}:import-effect:{label}"))
        # V2: ungated construction of an owned-module class.
        for ck in sorted(ctor_sites, key=lambda k: (k[0], k[1])):
            if ck[0] not in owned:
                continue
            for key, n in ctor_sites[ck]:
                if id(n) in gated(key) or key in protected:
                    continue
                findings.append(Finding(
                    code="RTA703", path=key[0], line=n.lineno,
                    message=f"{ck[1]} (owned by default-off {flag}) "
                            f"is constructed in {disp(key)}() without "
                            f"passing the flag gate",
                    hint=f"guard the construction with the {flag} "
                         f"gate, or move it behind a protected "
                         f"(all-call-sites-gated) helper",
                    anchor=f"{flag}:unguarded-ctor:{ck[1]}"
                           f"@{disp(key)}"))
        # V3: ungated effect in an owned-module function that is not
        # protected by construction/call-site gating.
        for c in contexts:
            if c.rel not in owned or c.key in protected:
                continue
            g = gated(c.key)
            for kind, label, n in self._node_effects(c.node):
                if id(n) in g:
                    continue
                findings.append(Finding(
                    code="RTA703", path=c.rel, line=n.lineno,
                    message=f"{disp(c.key)}() in {flag}-owned "
                            f"{c.rel} reaches {kind} effect {label} "
                            f"without the flag gate (and the "
                            f"function is reachable off-path)",
                    hint="gate the effect, or gate every call site "
                         "so the function becomes protected",
                    anchor=f"{flag}:offpath:{disp(c.key)}:{label}"))
        # V4: owned-prefix metric series registered outside the owned
        # modules without a gate.
        for c in contexts:
            if c.rel in owned or c.key in protected:
                continue
            g = gated(c.key)
            for kind, label, n in self._node_effects(c.node):
                if kind != "series" or id(n) in g:
                    continue
                if label.startswith(series_prefixes):
                    findings.append(Finding(
                        code="RTA703", path=c.rel, line=n.lineno,
                        message=f"metric series {label} (a {flag} "
                                f"surface) is registered in "
                                f"{disp(c.key)}() without the flag "
                                f"gate — it would appear on scrapes "
                                f"with the flag off",
                        hint="register the series under the flag "
                             "gate (the disabled-means-free "
                             "discipline)",
                        anchor=f"{flag}:series:{label}"))
        return findings

    def _import_effects(self, tree, test):
        """(gated, kind, label, node) for effects executed at import
        time: the top-level statement walk descends class bodies but
        never function bodies, tracking flag gates on the way."""
        out: List[Tuple[bool, str, str, ast.AST]] = []

        def stmts(body, gate: bool):
            for st in body:
                if isinstance(st, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                    continue
                if isinstance(st, ast.ClassDef):
                    stmts(st.body, gate)
                    continue
                if isinstance(st, ast.If):
                    stmts(st.body, gate or test(st.test))
                    stmts(st.orelse, gate)
                    continue
                if isinstance(st, ast.Try):
                    stmts(st.body, gate)
                    for h in st.handlers:
                        stmts(h.body, gate)
                    stmts(st.orelse, gate)
                    stmts(st.finalbody, gate)
                    continue
                for kind, label, n in self._node_effects(st):
                    out.append((gate, kind, label, n))

        stmts(tree.body, False)
        return out
