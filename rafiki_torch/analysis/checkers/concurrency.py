"""RTA104-106 — whole-program concurrency: the cross-object races the
per-class RTA1xx checkers cannot see.

Historical bugs this encodes (in the reference; docs/analysis.md):

- the persist-pipeline circuit-breaker reset and the
  promote double-allocation were both *cross-object* bugs that
  survived review precisely because RTA1xx reasoned one class at a
  time;
- the promote path deliberately blocks under a node-wide lock
  (waived), and review had to find every accidental sibling by hand.

All three codes ride :class:`analysis.program.Program` — the shared
symbol table / call graph / lock graph built once per run:

RTA104: interprocedural lock-order cycle whose locks live in MORE THAN
ONE class (the intra-class form stays RTA103). Method A of class X
holding ``X._lock`` while a helper three frames down takes
``Y._lock``, while some path orders them the other way, deadlocks the
moment both run concurrently — across classes and modules.

RTA105: blocking call (the RTA102 predicate, plus bus/broker
round-trips through typed receivers) reached THROUGH the call graph
while a lock is held. RTA102 flags ``time.sleep`` under ``with
self._lock:`` in the same method; RTA105 flags the same sleep three
frames down in another module.

RTA106: an attribute written from one THREAD ROOT and accessed from
another with NO lock held on either side anywhere (``Thread(target=)``
bodies, executor-submitted closures, HTTP route handlers — the
program's thread-root inventory). Attributes that are guarded
*somewhere* stay RTA101 territory; RTA106 exists for state nobody ever
locks — the unguarded-cross-thread-write class.

Known blind spots (documented in docs/analysis.md): dynamic dispatch
(``getattr``/callables in containers), receivers whose type does not
resolve through the bounded alias rules, locks passed as arguments,
and chains deeper than ``program.MAX_CHAIN_DEPTH`` frames.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..core import Checker, Finding, RepoContext, register
from ..program import Program


def _sccs(graph: Dict[str, Set[str]]) -> List[Set[str]]:
    """Tarjan, iterative; returns the strongly connected components of
    the lock digraph (singletons included — callers filter)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[Set[str]] = []
    counter = [0]

    def strongconnect(root: str) -> None:
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                comp: Set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.add(w)
                    if w == v:
                        break
                out.append(comp)

    for node in sorted(graph):
        if node not in index:
            strongconnect(node)
    return out


@register
class ConcurrencyChecker(Checker):
    name = "concurrency"
    codes = ("RTA104", "RTA105", "RTA106")
    #: Interprocedural facts need the full symbol table, so this is a
    #: repo-scope checker: it runs whole-program whenever any package
    #: file changed.
    scope = "repo"

    def run(self, ctx: RepoContext) -> List[Finding]:
        program = ctx.program()
        findings: List[Finding] = []
        findings.extend(self._lock_cycles(program))
        findings.extend(self._blocking_chains(program))
        findings.extend(self._cross_root_state(program))
        return findings

    # --- RTA104: cross-class lock-order cycles ---

    def _lock_edges(self, program: Program
                    ) -> Dict[Tuple[str, str], Tuple[tuple, int, str]]:
        """(outer, inner) -> (method key, line, how). Edges come from a
        direct acquisition under a held lock and from a call made under
        a held lock into a method whose transitive closure acquires
        more locks."""
        closure = program.locks_closure()
        edges: Dict[Tuple[str, str], Tuple[tuple, int, str]] = {}
        for key, s in program.summaries().items():
            for lock_id, held, line in s.direct_locks:
                for outer in held:
                    edges.setdefault((outer, lock_id),
                                     (key, line, "acquires"))
            for held, target, line, label in s.calls:
                if not held or target is None:
                    continue
                for inner in closure.get(target, ()):
                    for outer in held:
                        if outer != inner:
                            edges.setdefault(
                                (outer, inner),
                                (key, line, f"calls {label or '?'}"))
        return edges

    def _lock_cycles(self, program: Program) -> List[Finding]:
        edges = self._lock_edges(program)
        findings: List[Finding] = []
        paired: Set[str] = set()
        for (a, b), (key, line, how) in sorted(edges.items()):
            if not (a < b and (b, a) in edges):
                continue
            owner = program.lock_owner(a)
            if owner == program.lock_owner(b) and \
                    program.by_modname.get(owner) is None:
                continue  # intra-class: RTA103's territory. Two locks
                # of one MODULE stay ours: free functions have no class
                # walk, so nothing else would ever see the cycle.
            anchor = f"{a}<->{b}"
            if anchor in paired:
                continue
            paired.add(anchor)
            paired.update((a, b))
            okey, oline, _ohow = edges[(b, a)]
            chain_ab = " -> ".join(program.lock_chain(key, b))
            chain_ba = " -> ".join(program.lock_chain(okey, a))
            findings.append(Finding(
                code="RTA104", path=key[0], line=line,
                message=f"cross-class lock-order cycle: {a} -> {b} "
                        f"({program.describe(key)} {how}; chain "
                        f"{chain_ab}) vs {b} -> {a} "
                        f"({program.describe(okey)} in "
                        f"{okey[0]}:{oline}; chain {chain_ba})",
                hint="pick ONE acquisition order for the two classes "
                     "and restructure the other path (snapshot under "
                     "one lock, act under the other)",
                anchor=anchor))
        # Longer cycles (A->B->C->A with no opposing pair) reduce to a
        # strongly connected component of the lock digraph. Report each
        # multi-class SCC not already covered by a pair finding.
        for scc in _sccs({a: {b for (x, b) in edges if x == a}
                          for (a, _b) in edges}):
            if len(scc) < 3 or any(lock in paired for lock in scc):
                continue
            owners = {program.lock_owner(x) for x in scc}
            if len(owners) < 2 and \
                    program.by_modname.get(next(iter(owners))) is None:
                continue
            cyc = sorted(scc)
            key, line, how = edges[next(
                (a, b) for a in cyc for b in cyc if (a, b) in edges)]
            findings.append(Finding(
                code="RTA104", path=key[0], line=line,
                message=f"cross-class lock-order cycle over "
                        f"{len(cyc)} locks: {' / '.join(cyc)} "
                        f"(first edge in {program.describe(key)}; "
                        f"every lock here is reachable from every "
                        f"other while held)",
                hint="pick ONE global acquisition order for these "
                     "classes and restructure the off-order paths",
                anchor="cycle:" + "|".join(cyc)))
        return findings

    # --- RTA105: blocking reached through the call graph under a lock ---

    def _blocking_chains(self, program: Program) -> List[Finding]:
        blocking = program.blocking_closure()
        # One DEFECT = one finding: a chain A -> B -> C -> sleep with
        # the lock held across every frame (the caller-holds fixpoint
        # makes each frame a candidate) must not demand a waiver per
        # frame. Group by (held locks, terminal blocking method,
        # label) and keep the frame CLOSEST to the block — the most
        # precise site, and the one a fix/waiver naturally anchors to.
        # rank is all-str/int (method keys contain None for module
        # functions and would TypeError under tuple comparison).
        best: Dict[tuple, Tuple[tuple, tuple, tuple, int]] = {}
        for key, s in program.summaries().items():
            for held, target, line, label in s.calls:
                if not held or target is None:
                    continue
                entry = blocking.get(target)
                if entry is None:
                    continue
                blabel = entry[0]
                terminal = target
                for _ in range(16):
                    nxt = blocking.get(terminal)
                    if nxt is None or nxt[2] is None:
                        break
                    terminal = nxt[2]
                depth = len(program.blocking_chain(target))
                group = (held, terminal, blabel)
                rank = (depth, key[0], program.describe(key), line)
                if group not in best or rank < best[group][0]:
                    best[group] = (rank, key, target, line)
        findings: List[Finding] = []
        for (held, _terminal, blabel), \
                (_rank, key, target, line) in sorted(
                    best.items(),
                    key=lambda kv: (kv[1][1][0], kv[1][0])):
            chain = [program.describe(key)] + \
                program.blocking_chain(target)
            locks = "/".join(sorted(held))
            findings.append(Finding(
                code="RTA105", path=key[0], line=line,
                message=f"{program.describe(key)}() holds {locks} "
                        f"while the call chain "
                        f"{' -> '.join(chain)} reaches blocking "
                        f"{blabel}",
                hint="release the lock before the call (snapshot "
                     "state under the lock, do the slow work "
                     "after), or waive with why the stall is "
                     "acceptable",
                anchor=(f"{program.describe(key)}->"
                        f"{program.describe(target)}:{blabel}")))
        # Direct blocking under a held lock in a FREE function — the
        # module-global-lock case. Inside a method the same shape is
        # RTA102's (per-class) territory; module-level code has no
        # class, so this is the only checker that can see it.
        seen: Set[Tuple[tuple, str]] = set()
        for key, s in sorted(program.summaries().items(),
                             key=lambda kv: (kv[0][0],
                                             str(kv[0][1]),
                                             kv[0][2])):
            if s.cls_key is not None:
                continue
            for held, blabel, line in s.held_blocking:
                if (key, blabel) in seen:
                    continue
                seen.add((key, blabel))
                findings.append(Finding(
                    code="RTA105", path=key[0], line=line,
                    message=f"{program.describe(key)}() holds "
                            f"{'/'.join(sorted(held))} while calling "
                            f"blocking {blabel} directly",
                    hint="move the blocking call outside the `with` "
                         "block, or waive with why the stall under "
                         "the module lock is acceptable",
                    anchor=f"{program.describe(key)}:{blabel}:direct"))
        return findings

    # --- RTA106: cross-thread-root unguarded shared state ---

    def _cross_root_state(self, program: Program) -> List[Finding]:
        findings: List[Finding] = []
        for mi in program.modules.values():
            for cname, cnode in sorted(mi.classes.items()):
                findings.extend(self._class_roots(
                    program, mi.rel, cname, cnode))
        return findings

    def _class_roots(self, program: Program, rel: str, cname: str,
                     cnode) -> List[Finding]:
        info = program.class_info(cnode)
        roots = dict(info.thread_roots())
        # Roots registered FROM OTHER classes (or free functions):
        # Thread(target=self.consumer.loop) in an owner makes loop a
        # root HERE — the bus-consumer shape, where the class that
        # owns the loop never constructs the thread itself.
        roots.update(program.extra_class_roots((rel, cname)))
        if not roots:
            return []
        graph = info.self_call_graph()
        extra = info.held_extra()

        def reach(starts: Set[str]) -> Set[str]:
            out = set(starts)
            frontier = list(starts)
            while frontier:
                m = frontier.pop()
                for callee in graph.get(m, ()):
                    if callee not in out:
                        out.add(callee)
                        frontier.append(callee)
            return out

        #: side name -> (reachable method set, closure-root or None).
        #: A closure root "meth/fn" owns accesses whose fn_stack
        #: contains fn inside meth; a method root owns its reach set.
        sides: Dict[str, Tuple[Set[str], Optional[Tuple[str, str]]]] = {}
        root_methods: Set[str] = set()
        for rid, (_kind, detail) in roots.items():
            if "/" in detail:
                meth, fn = detail.split("/", 1)
                sides[rid] = (set(), (meth, fn))
            else:
                sides[rid] = (reach({detail}), None)
                root_methods.add(detail)
        public = {m.name for m in info.methods()
                  if not m.name.startswith("_")} - root_methods
        caller_reach = reach(public)
        sides["caller"] = (caller_reach, None)

        def side_of(acc) -> List[str]:
            out = []
            for sid, (methods, closure) in sides.items():
                if closure is not None:
                    meth, fn = closure
                    if acc.method == meth and fn in acc.fn_stack:
                        out.append(sid)
                elif acc.method in methods and not acc.fn_stack:
                    out.append(sid)
            return out

        def effective(acc) -> frozenset:
            if acc.nested:
                return acc.held
            return acc.held | extra.get(acc.method, frozenset())

        candidates = (info.state_attrs - info.lock_attrs
                      - info.atomic_attrs - info.thread_attrs)
        # Guarded-somewhere attrs are RTA101's job; RTA106 is for state
        # nobody ever locks.
        ever_locked = {acc.attr for acc in info.accesses
                       if effective(acc)}
        findings: List[Finding] = []
        for attr in sorted(candidates - ever_locked):
            accs = [a for a in info.accesses
                    if a.attr == attr and a.method != "__init__"]
            by_side: Dict[str, List] = {}
            for a in accs:
                for sid in side_of(a):
                    by_side.setdefault(sid, []).append(a)
            if len(by_side) < 2:
                continue
            write_sides = {sid for sid, lst in by_side.items()
                           if any(a.is_write for a in lst)}
            if not write_sides:
                continue
            wsid = sorted(write_sides)[0]
            wacc = next(a for a in by_side[wsid] if a.is_write)
            osid = next(s for s in sorted(by_side) if s != wsid)
            oacc = by_side[osid][0]
            root_desc = {sid: roots[sid][1] if sid in roots else "callers"
                         for sid in (wsid, osid)}
            findings.append(Finding(
                code="RTA106", path=rel, line=wacc.line,
                message=f"{cname}.{attr} is written from thread root "
                        f"{root_desc[wsid]!r} ({wacc.method}:"
                        f"{wacc.line}) and "
                        f"{'written' if oacc.is_write else 'read'} "
                        f"from {root_desc[osid]!r} ({oacc.method}:"
                        f"{oacc.line}) with no lock held on either "
                        f"side",
                hint="guard both sides with one lock, hand the value "
                     "over through a Queue/Event, or waive with why "
                     "the race is benign (e.g. monotonic flag, "
                     "GIL-atomic scalar)",
                anchor=f"{cname}.{attr}:cross-root"))
        return findings
