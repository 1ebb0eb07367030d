"""Framework core: finding model, checker registry, waivers, baseline.

Design constraints, in order:

- **Stdlib only, zero imports from the rest of the package.** The suite
  must run where torch cannot (pre-commit hooks, the docs CI image) and
  must not execute the code it analyzes — everything is ``ast`` over
  source text, ``config.py``'s ``NodeConfig`` included (the drift
  checker reads its fields from the AST; the reference's loads the
  file by path, which the port's relative imports do not allow).
- **Stable finding identity.** Baselines must survive unrelated edits,
  so a finding's identity is ``CODE:path:anchor`` where ``anchor`` is a
  checker-chosen symbol (``MicroBatcher._dt_ewma@current_fill_window``,
  an env-var name, a metric name) — never a line number.
- **A waiver is a reviewed decision, not an escape hatch.** Inline
  waivers (``# rta: disable=RTA101 <reason>``) and baseline entries
  both REQUIRE a reason; a reasonless one is itself a finding (RTA001/
  RTA002) that cannot be waived.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import json
import os
import re
import subprocess
import time
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: The package the suite analyses, relative to the checkout's root.
PKG = "rafiki_torch"

#: Meta-codes emitted by the framework itself (not waivable).
CODE_WAIVER_NO_REASON = "RTA001"
CODE_BASELINE_NO_REASON = "RTA002"
CODE_STALE_WAIVER = "RTA003"
_UNWAIVABLE = {CODE_WAIVER_NO_REASON, CODE_BASELINE_NO_REASON,
               CODE_STALE_WAIVER}

WAIVER_RE = re.compile(
    r"#\s*rta:\s*disable=([A-Z0-9x,]+)(?:\s+(\S.*))?\s*$")


@dataclasses.dataclass
class Finding:
    """One defect the suite reports.

    ``anchor`` is the stable symbol the baseline keys on; checkers MUST
    set one that survives line drift (class.attr, env name, ...).
    ``status`` is assigned by :func:`run_suite`: ``new`` (fails CI),
    ``waived`` (inline comment), or ``baselined`` (frozen pre-existing).
    """

    code: str
    path: str            # repo-relative, forward slashes
    line: int
    message: str
    hint: str = ""
    anchor: str = ""
    status: str = "new"
    reason: str = ""     # the waiver/baseline reason, when not new

    @property
    def ident(self) -> str:
        return f"{self.code}:{self.path}:{self.anchor or self.line}"

    def render(self) -> str:
        out = f"{self.path}:{self.line}: {self.code} {self.message}"
        if self.hint:
            out += f" [hint: {self.hint}]"
        return out

    def to_json(self) -> Dict[str, object]:
        return {"code": self.code, "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint,
                "id": self.ident, "status": self.status,
                "reason": self.reason}


class Module:
    """One parsed source file. ``tree`` is None on a syntax error (the
    error itself is reported by :func:`run_suite`, so a checker never
    needs to guard against it)."""

    def __init__(self, root: str, rel: str):
        self.rel = rel.replace(os.sep, "/")
        self.path = os.path.join(root, rel)
        with open(self.path, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.syntax_error: Optional[str] = None
        try:
            self.tree = ast.parse(self.text, filename=self.rel)
        except SyntaxError as e:
            self.syntax_error = f"{e.msg} (line {e.lineno})"

    def waivers(self) -> Dict[int, Tuple[Set[str], str]]:
        """line -> (codes, reason). Only REAL comment tokens count:
        waiver-shaped text inside a string/docstring must neither
        suppress a finding nor mint a phantom RTA001. Cached on first
        use."""
        cached = getattr(self, "_waivers", None)
        if cached is None:
            cached = {}
            for line, comment in self._comments():
                m = WAIVER_RE.search(comment)
                if m:
                    codes = {c.strip() for c in m.group(1).split(",")
                             if c.strip()}
                    cached[line] = (codes, (m.group(2) or "").strip())
            self._waivers = cached
        return cached

    def _comments(self) -> List[Tuple[int, str]]:
        """(line, text) of every comment token. On a file the tokenizer
        rejects (already an RTA000 finding) fall back to raw lines so a
        waiver on a salvageable line still parses."""
        out: List[Tuple[int, str]] = []
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    out.append((tok.start[0], tok.string))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return [(i, ln) for i, ln in enumerate(self.lines, 1)]
        return out


class RepoContext:
    """Everything a checker may look at: the parsed package modules,
    non-Python repo files, and (in ``--changed`` mode) the changed set.
    """

    #: Directories scanned for Python modules, relative to root.
    PY_ROOTS = (PKG,)

    def __init__(self, root: str, changed: Optional[Set[str]] = None):
        self.root = os.path.abspath(root)
        self.changed = ({c.replace(os.sep, "/") for c in changed}
                        if changed is not None else None)
        self.modules: List[Module] = []
        for pyroot in self.PY_ROOTS:
            top = os.path.join(self.root, pyroot)
            if not os.path.isdir(top):
                continue
            for dirpath, dirnames, filenames in os.walk(top):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        rel = os.path.relpath(os.path.join(dirpath, fn),
                                              self.root)
                        self.modules.append(Module(self.root, rel))

    def target_modules(self) -> List[Module]:
        """Modules a per-file checker should flag: all of them, or the
        changed subset in ``--changed`` mode."""
        if self.changed is None:
            return self.modules
        return [m for m in self.modules if m.rel in self.changed]

    def program(self):
        """The whole-program model (``analysis.program.Program``) over
        ALL parsed modules, built lazily ONCE per run and shared by
        every checker — the single-parse/single-walk contract. Always
        repo-wide, even in ``--changed`` mode: interprocedural facts
        (a lock chain ending three modules away) are only sound with
        the full symbol table."""
        cached = getattr(self, "_program", None)
        if cached is None:
            from . import program as _program

            cached = _program.Program(self.modules)
            self._program = cached
        return cached

class Checker:
    """Base class; subclasses register via :func:`register`.

    ``scope`` is ``"file"`` (operates on ``ctx.target_modules()``; in
    ``--changed`` mode it simply sees fewer modules) or ``"repo"``
    (needs a global view — runs when any changed path matches
    ``triggers``, and always in full runs).
    """

    name = "base"
    codes: Tuple[str, ...] = ()
    scope = "file"
    #: fnmatch patterns (repo-relative) that make a repo-scope checker
    #: run in --changed mode.
    triggers: Tuple[str, ...] = (f"{PKG}/*", f"{PKG}/*/*",
                                 f"{PKG}/*/*/*")

    def run(self, ctx: RepoContext) -> List[Finding]:
        raise NotImplementedError

    def should_run(self, ctx: RepoContext) -> bool:
        if ctx.changed is None or self.scope == "file":
            return True
        return any(fnmatch.fnmatch(c, pat) for c in ctx.changed
                   for pat in self.triggers)


_CHECKERS: List[Checker] = []


def register(checker_cls):
    """Class decorator; instantiates and registers the checker."""
    _CHECKERS.append(checker_cls())
    return checker_cls


def all_checkers() -> List[Checker]:
    from . import checkers  # noqa: F401  (import registers them)

    return list(_CHECKERS)


# --- Baseline ---------------------------------------------------------

def baseline_path() -> str:
    """The committed baseline that freezes pre-existing findings."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: Optional[str]) -> Dict[str, str]:
    """id -> reason. Missing file = empty baseline (fresh tree)."""
    if not path or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {e["id"]: e.get("reason", "")
            for e in data.get("findings", [])}


def save_baseline(path: str, findings: Iterable[Finding],
                  prior: Dict[str, str]) -> int:
    """``--update-baseline``: freeze the current new findings, keeping
    the reason of every entry that already had one. New entries get an
    UNREVIEWED placeholder that RTA002 keeps failing until a human
    writes the real reason — updating the baseline is never silently
    green."""
    entries = []
    seen = set()
    for f in sorted(findings, key=lambda f: f.ident):
        # Meta-findings (reasonless waiver/baseline entry) are never
        # consulted from the baseline at classification time, so
        # freezing them would only accrete dead line-anchored entries.
        if f.status == "waived" or f.ident in seen \
                or f.code in _UNWAIVABLE:
            continue
        seen.add(f.ident)
        reason = prior.get(f.ident, "")
        entries.append({
            "id": f.ident, "reason": reason or
            "UNREVIEWED: replace with why this finding is accepted",
            "where": f"{f.path}:{f.line}", "message": f.message})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "findings": entries}, f, indent=1,
                  sort_keys=False)
        f.write("\n")
    return len(entries)


# --- Suite ------------------------------------------------------------

@dataclasses.dataclass
class Report:
    root: str
    findings: List[Finding]
    n_files: int
    checkers: List[str]
    stale_baseline: List[str]
    #: Every code a checker that RAN could have emitted — so
    #: counts_per_code carries explicit zeros (chip_smoke.py's analysis
    #: phase prints per-code counts; a zero for RTA104 is evidence the
    #: gate looked, absence would be ambiguous).
    covered_codes: List[str] = dataclasses.field(default_factory=list)
    #: Per-checker wall time (seconds) — the --diff mode's cost
    #: breakdown, so a checker that stops scaling is visible in CI
    #: output instead of as a slowly rotting gate latency.
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def new(self) -> List[Finding]:
        return [f for f in self.findings if f.status == "new"]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {c: 0 for c in self.covered_codes}
        for f in self.findings:
            out[f.code] = out.get(f.code, 0) + 1
        return dict(sorted(out.items()))

    def to_json(self) -> Dict[str, object]:
        by_status: Dict[str, int] = {}
        for f in self.findings:
            by_status[f.status] = by_status.get(f.status, 0) + 1
        return {
            "root": self.root,
            "files": self.n_files,
            "checkers": self.checkers,
            "counts_per_code": self.counts(),
            "by_status": by_status,
            "new": len(self.new),
            "stale_baseline": self.stale_baseline,
            "timings_s": {k: round(v, 4)
                          for k, v in self.timings.items()},
            "findings": [f.to_json() for f in self.findings],
        }


def run_suite(root: str, changed: Optional[Set[str]] = None,
              baseline: Optional[Dict[str, str]] = None,
              only: Optional[Sequence[str]] = None) -> Report:
    """Run every registered checker and classify findings against the
    inline waivers and the baseline. ``only`` filters by checker name.
    """
    ctx = RepoContext(root, changed=changed)
    baseline = baseline or {}
    findings: List[Finding] = []

    # A file the suite cannot parse is a finding, not a crash.
    for mod in ctx.target_modules():
        if mod.syntax_error is not None:
            findings.append(Finding(
                code="RTA000", path=mod.rel, line=1,
                message=f"syntax error: {mod.syntax_error}",
                anchor="syntax"))

    ran = []
    covered: List[str] = []
    timings: Dict[str, float] = {}
    for checker in all_checkers():
        if only and checker.name not in only:
            continue
        if not checker.should_run(ctx):
            continue
        ran.append(checker.name)
        covered.extend(checker.codes)
        t0 = time.perf_counter()
        findings.extend(checker.run(ctx))
        timings[checker.name] = time.perf_counter() - t0

    # Reason-less waivers are findings in their own right, everywhere
    # (including modules no checker flagged).
    waiver_index: Dict[str, Dict[int, Tuple[Set[str], str]]] = {}
    for mod in ctx.modules:
        w = mod.waivers()
        if w:
            waiver_index[mod.rel] = w
        if ctx.changed is None or mod.rel in ctx.changed:
            for line, (codes, reason) in w.items():
                if not reason:
                    findings.append(Finding(
                        code=CODE_WAIVER_NO_REASON, path=mod.rel,
                        line=line,
                        message="waiver without a reason: "
                                "`# rta: disable=%s` must say why"
                                % ",".join(sorted(codes)),
                        anchor=f"waiver:{line}"))

    # Classify: inline waiver first (same line or the line above the
    # finding — the comment-above form keeps long lines readable),
    # baseline second. Waiver lines that actually suppressed a finding
    # are remembered: a reasoned waiver no finding matches anymore is
    # itself a finding (RTA003 below) — silently rotting disables are
    # how a real regression later slips in pre-waived.
    used_waivers: Set[Tuple[str, int]] = set()
    seen: Set[str] = set()
    deduped: List[Finding] = []
    for f in findings:
        if f.ident in seen:
            continue
        seen.add(f.ident)
        if f.code not in _UNWAIVABLE:
            waivers = waiver_index.get(f.path, {})
            for line in (f.line, f.line - 1):
                entry = waivers.get(line)
                if entry and _waiver_covers(entry[0], f.code) \
                        and entry[1]:
                    f.status, f.reason = "waived", entry[1]
                    used_waivers.add((f.path, line))
                    break
            if f.status == "new" and f.ident in baseline:
                reason = baseline[f.ident]
                if reason and not reason.startswith("UNREVIEWED"):
                    f.status, f.reason = "baselined", reason
                else:
                    deduped.append(Finding(
                        code=CODE_BASELINE_NO_REASON, path=f.path,
                        line=f.line,
                        message=f"baseline entry {f.ident} has no "
                                f"reviewed reason",
                        anchor=f"baseline:{f.ident}"))
                    f.status, f.reason = "baselined", reason
        deduped.append(f)

    # Stale-WAIVER detection (RTA003): a reasoned `# rta: disable=`
    # comment that suppressed nothing this run is dead — either the
    # guarded defect was fixed (delete the comment) or the code it
    # names is a typo (it never guarded anything). Only sound when the
    # full file view ran (``--changed`` skips unscanned modules whose
    # waivers would all read unused); under ``--checker`` scoping a
    # waiver counts only when a ran checker COVERS one of its codes.
    if changed is None:
        for mod in ctx.modules:
            for line, (codes, reason) in mod.waivers().items():
                if not reason or (mod.rel, line) in used_waivers:
                    continue  # reasonless = RTA001's finding already
                if only and not any(_code_covered(c, covered)
                                    for c in codes):
                    continue  # that checker didn't run this time
                deduped.append(Finding(
                    code=CODE_STALE_WAIVER, path=mod.rel, line=line,
                    message="stale waiver: `# rta: disable=%s` "
                            "suppresses nothing — the finding no "
                            "longer fires (or the code is unknown); "
                            "delete the comment"
                            % ",".join(sorted(codes)),
                    hint="a dead disable pre-waives the NEXT "
                         "regression on this line; remove it (or fix "
                         "the code list if it was a typo)",
                    anchor=f"stale-waiver:{line}"))

    # Stale detection is only sound on a FULL run: a scoped run
    # (--changed / --checker) never produces findings for unscanned
    # files or checkers, so their live baseline entries would all look
    # "fixed".
    if changed is None and not only:
        stale = sorted(set(baseline) - {f.ident for f in deduped})
    else:
        stale = []
    return Report(root=ctx.root, findings=deduped,
                  n_files=len(ctx.modules), checkers=ran,
                  stale_baseline=stale, covered_codes=covered,
                  timings=timings)


def _waiver_covers(codes: Set[str], code: str) -> bool:
    """``RTA101`` matches exactly; ``RTA1xx`` waives the whole class."""
    if code in codes:
        return True
    return any(c.endswith("xx") and code.startswith(c[:-2])
               for c in codes)


def _code_covered(code: str, covered: Sequence[str]) -> bool:
    """Whether a waiver's ``code`` (exact or ``RTAxx`` class form)
    belongs to a checker that RAN — the RTA003 scoping guard.
    Framework meta-codes count as always covered (run_suite itself
    emits them every run, and they are unwaivable — a waiver naming
    one is dead by construction)."""
    if code in covered or code in _UNWAIVABLE or code == "RTA000":
        return True
    if code.endswith("xx"):
        return any(c.startswith(code[:-2]) for c in covered)
    return False


# --- Git (--changed mode) --------------------------------------------

def changed_files(root: str, base: Optional[str] = None) -> Set[str]:
    """Repo-relative paths touched since the merge-base with main plus
    anything uncommitted/untracked — the fast pre-commit scope. An
    explicit ``base`` (``--diff <base>``) pins the comparison point
    instead of discovering it (CI diffing a PR against its merge
    target, or re-running against an arbitrary commit)."""

    def git(*args: str) -> List[str]:
        try:
            out = subprocess.run(
                ["git", "-C", root, *args], capture_output=True,
                text=True, timeout=30)
        except OSError:
            return []
        if out.returncode != 0:
            return []
        return [ln.strip() for ln in out.stdout.splitlines()
                if ln.strip()]

    if base is None:
        base = "HEAD"
        for ref in ("origin/main", "origin/master", "main", "master"):
            mb = git("merge-base", "HEAD", ref)
            if mb:
                base = mb[0]
                break
    changed: Set[str] = set()
    changed.update(git("diff", "--name-only", base))
    changed.update(git("diff", "--name-only"))           # worktree
    changed.update(git("diff", "--name-only", "--cached"))
    changed.update(git("ls-files", "--others", "--exclude-standard"))
    return {c.replace(os.sep, "/") for c in changed}


def repo_root() -> str:
    """The checkout this package sits in (three levels up)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))
