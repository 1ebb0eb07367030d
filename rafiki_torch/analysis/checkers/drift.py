"""RTA5xx — drift: the contracts that rot silently when only humans
enforce them.

The reference's drift checker folded in two tier-1 scripts
(``scripts/``, now shims over the reference's module); the port's runs
the same checks over its own tree:

RTA501: every metric registered anywhere follows
``rafiki_tpu_<subsystem>_<name>_<unit>`` (was
``scripts/check_metrics_names.py``; the metrics plane shipped with
this gate because one typo'd name forks the namespace forever).
RTA502: every ``rafiki_tpu_*`` token a Grafana dashboard references is
a registered name — a renamed metric breaks the build instead of
silently blanking a panel.
RTA503: every NodeConfig env knob appears in the ``docs/ops.md`` knob
table (was ``scripts/check_knob_docs.py``; the audit found three
generations of knobs nobody had documented).
RTA504 (new): every ``RAFIKI_TPU_*`` string literal *read* anywhere in
the tree is a NodeConfig knob or a ServicesManager-injected identity
var (``constants.EnvVars``) — ad-hoc ``os.environ.get`` knobs are how
the audit's three undocumented generations happened in the first
place.
RTA505 (new): every NodeConfig knob whose env var is read at worker
construction time is exported by ``apply_env()`` — otherwise spawned
children resolve different values than the node validated.
RTA506: every metric name the SLO plane READS — the consumed-
series vocabulary in ``observe/slo.py``/``admin/slo_engine.py`` and
every ``metric`` reference in a committed SLO rules file under
``docs/slo/`` — is a registered series name (same machinery as the
RTA502 Grafana check): a renamed source series must break the build,
not silently blank every objective that reads it.

The name vocabulary (subsystems, units) lives HERE: extending it is a
deliberate reviewed edit.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from ..core import PKG, Checker, Finding, RepoContext, register

PREFIX = "rafiki_tpu_"

SUBSYSTEMS = {"bus", "serving", "http", "train", "trial", "trace",
              "node", "fault", "autoscale", "profile", "slo",
              "workload", "capacity", "lm", "relay"}

# _total marks counters (Prometheus convention); everything else is the
# physical unit of a gauge/histogram. "rate" is the SLO plane's burn
# rate (budget fractions per window-length — dimensionless but not a
# 0..1 ratio). "tokens" is the generative-serving unit (resident-KV
# gauge; token counters end _total like every counter).
# "peers" is the cluster registry's unit (live-peer-count gauge;
# relay/fabric traffic counters end _total like every counter).
UNITS = {"total", "seconds", "ratio", "bytes", "queries", "batches",
         "info", "replicas", "rate", "tokens", "peers"}

NAME_RE = re.compile(r"^rafiki_tpu_[a-z0-9]+(?:_[a-z0-9]+)+$")

#: Any rafiki_tpu_* token inside a dashboard JSON (panel exprs,
#: label_values templating queries, ...).
DASH_TOKEN_RE = re.compile(r"\brafiki_tpu_[a-z0-9_]+\b")

#: Exposition-level suffixes a histogram's series carry beyond its
#: registered name.
HIST_SUFFIXES = ("_bucket", "_sum", "_count")

ENV_PREFIX = "RAFIKI_TPU_"
#: A full env name: prefix fragments like "RAFIKI_TPU_SERVING_" (used
#: to CONSTRUCT names) are not reads of a specific knob.
ENV_NAME_RE = re.compile(r"^RAFIKI_TPU_[A-Z0-9_]*[A-Z0-9]$")

#: Modules the env-drift scan skips: the knob layer itself, the
#: injected-identity registry, and this suite.
ENV_SCAN_SKIP = (f"{PKG}/config.py", f"{PKG}/constants.py",
                 f"{PKG}/analysis/")


def _parsed_modules(modules) -> List[Tuple[str, str, Optional[ast.AST]]]:
    """(rel, text, tree-or-None) of the ctx's already-parsed ``Module``
    list: the repo is read and parsed exactly once per run."""
    return [(m.rel, m.text, m.tree) for m in modules]


# --- RTA501/RTA502: metric names + dashboard references ---------------

def check_metric_names(modules) -> Tuple[List[Finding], Set[str], int]:
    """All naming findings plus the registered-name set (for the
    dashboard cross-check) and the file count."""
    findings: List[Finding] = []
    registered: Set[str] = set()
    files = _parsed_modules(modules)
    for rel, text, tree in files:
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fname = node.func.attr if isinstance(node.func, ast.Attribute) \
                else (node.func.id if isinstance(node.func, ast.Name)
                      else "")
            if fname not in ("counter", "gauge", "histogram"):
                continue
            if not node.args or not isinstance(node.args[0], ast.Constant) \
                    or not isinstance(node.args[0].value, str):
                continue
            name = node.args[0].value
            if not name.startswith(PREFIX):
                continue
            registered.add(name)
            findings.extend(_judge_name(rel, node.lineno, fname, name))
    return findings, registered, len(files)


def _judge_name(rel: str, line: int, kind: str,
                name: str) -> List[Finding]:
    out = []

    def f(tag: str, message: str) -> Finding:
        return Finding(code="RTA501", path=rel, line=line,
                       message=message, anchor=f"{name}:{tag}",
                       hint="extend the vocabulary in rafiki_torch/"
                            "analysis/checkers/drift.py if intentional")

    if not NAME_RE.match(name):
        out.append(f("shape", f"{name!r} is not "
                              f"rafiki_tpu_<subsystem>_<name>_<unit>"))
        return out
    tokens = name[len(PREFIX):].split("_")
    if tokens[0] not in SUBSYSTEMS:
        out.append(f("subsystem",
                     f"{name!r} subsystem {tokens[0]!r} not in "
                     f"{sorted(SUBSYSTEMS)}"))
    unit = tokens[-1]
    if unit not in UNITS:
        out.append(f("unit", f"{name!r} unit {unit!r} not in "
                            f"{sorted(UNITS)}"))
    if kind == "counter" and unit != "total":
        out.append(f("counter-total",
                     f"counter {name!r} must end in _total"))
    if kind != "counter" and unit == "total":
        out.append(f("total-not-counter",
                     f"{kind} {name!r} must not end in _total"))
    return out


def _strip_hist_suffix(name: str, registered: Set[str]) -> str:
    for suffix in HIST_SUFFIXES:
        if name.endswith(suffix) and name[:-len(suffix)] in registered:
            return name[:-len(suffix)]
    return name


def _scan_artifact_tokens(rel: str, text: str, registered: Set[str],
                          code: str, message_fmt: str,
                          ) -> List[Finding]:
    """Every ``rafiki_tpu_*`` token in one committed artifact (Grafana
    dashboard, SLO rules file) must be a registered series name after
    the histogram-suffix strip; ``message_fmt`` takes ``{name!r}``."""
    findings: List[Finding] = []
    for name in sorted(set(DASH_TOKEN_RE.findall(text))):
        if _strip_hist_suffix(name, registered) in registered:
            continue
        # Boundary-anchored like the extraction above — a plain
        # find() would land inside a longer token (e.g. the
        # `_total` form of the same name) on an earlier line.
        m = re.search(r"\b%s\b" % re.escape(name), text)
        line = text[:m.start()].count("\n") + 1
        findings.append(Finding(
            code=code, path=rel, line=line,
            message=message_fmt.format(name=name), anchor=name))
    return findings


def check_dashboards(root: str,
                     registered: Set[str]) -> Tuple[List[Finding], int]:
    """Every metric a dashboard references must be a registered name
    (after stripping the histogram exposition suffixes)."""
    findings: List[Finding] = []
    grafana = os.path.join(root, "docs", "grafana")
    n_dash = 0
    if not os.path.isdir(grafana):
        return findings, 0
    for fn in sorted(os.listdir(grafana)):
        if not fn.endswith(".json"):
            continue
        n_dash += 1
        rel = f"docs/grafana/{fn}"
        with open(os.path.join(grafana, fn), encoding="utf-8") as f:
            text = f.read()
        try:
            json.loads(text)
        except json.JSONDecodeError as e:
            findings.append(Finding(
                code="RTA502", path=rel, line=1,
                message=f"invalid JSON ({e})", anchor="json"))
            continue
        findings.extend(_scan_artifact_tokens(
            rel, text, registered, "RTA502",
            "references {name!r}, which no code path registers "
            "(renamed metric? update the dashboard)"))
    return findings, n_dash


# --- RTA506: SLO plane metric references ------------------------------

#: Modules whose rafiki_tpu_* string constants are READS of series the
#: SLO plane consumes (they also REGISTER their own rafiki_tpu_slo_*
#: gauges — registration is covered by the RTA501 scan, so those names
#: are in the registered set and pass trivially).
SLO_MODULES = (f"{PKG}/observe/slo.py",
               f"{PKG}/admin/slo_engine.py")

#: Committed SLO rules files live here (examples + deploy defaults).
SLO_RULES_DIR = os.path.join("docs", "slo")


def check_slo_refs(root: str, registered: Set[str], modules
                   ) -> List[Finding]:
    """RTA506: SLO-consumed series names must be registered. Two
    sources: (1) full-shape metric-name string constants inside the
    SLO modules (the CONSUMED_SERIES vocabulary and any literal the
    engine matches on), (2) every ``rafiki_tpu_*`` token in a rules
    file under docs/slo/ (the ``metric`` override field included)."""
    findings: List[Finding] = []
    by_rel = {rel: (text, tree)
              for rel, text, tree in _parsed_modules(modules)}
    for rel in SLO_MODULES:
        if rel not in by_rel:
            continue
        text, tree = by_rel[rel]
        if tree is None:
            continue
        seen: Set[str] = set()
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            name = node.value
            if not NAME_RE.match(name):
                continue
            base = _strip_hist_suffix(name, registered)
            if base in registered or base in seen:
                continue
            seen.add(base)
            findings.append(Finding(
                code="RTA506", path=rel, line=node.lineno,
                message=f"SLO plane consumes {name!r}, which no code "
                        f"path registers (renamed source series? "
                        f"update the SLO vocabulary)",
                hint="fix the name in CONSUMED_SERIES / the engine, "
                     "or register the series it expects",
                anchor=name))
    rules_dir = os.path.join(root, SLO_RULES_DIR)
    if os.path.isdir(rules_dir):
        for fn in sorted(os.listdir(rules_dir)):
            if not (fn.endswith(".json") or fn.endswith(".toml")):
                continue
            rel = f"docs/slo/{fn}"
            with open(os.path.join(rules_dir, fn),
                      encoding="utf-8") as f:
                text = f.read()
            if fn.endswith(".json"):
                try:
                    json.loads(text)
                except json.JSONDecodeError as e:
                    findings.append(Finding(
                        code="RTA506", path=rel, line=1,
                        message=f"invalid JSON ({e})", anchor="json"))
                    continue
            findings.extend(_scan_artifact_tokens(
                rel, text, registered, "RTA506",
                "SLO rules reference {name!r}, which no code path "
                "registers (renamed metric? update the rules file)"))
    return findings


# --- RTA503: knob docs ------------------------------------------------

class NodeConfigSpec:
    """NodeConfig's knobs as ``config.py``'s source declares them.

    Read from the AST, never executed: the port's ``config.py`` imports
    ``.observe.wire`` relatively, so loading it alone by path fails, and
    loading it inside its package would run code the suite analyses.
    The fields are the annotated names of the ``NodeConfig`` class body
    (a ``ClassVar`` annotation is not a field, as for ``@dataclass``);
    a field's env name is ``_ENV_MAP``'s entry, else the module's
    ``_PREFIX`` (default ``RAFIKI_TPU_``) and the field in capitals,
    which is what ``NodeConfig.env_name`` returns."""

    def __init__(self, tree: ast.AST):
        self.prefix = ENV_PREFIX
        self.fields: List[str] = []
        self.env_map: Dict[str, str] = {}
        cls = None
        for node in getattr(tree, "body", []):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str) and \
                    any(isinstance(t, ast.Name) and t.id == "_PREFIX"
                        for t in node.targets):
                self.prefix = node.value.value
            elif isinstance(node, ast.ClassDef) and \
                    node.name == "NodeConfig":
                cls = node
        if cls is None:
            raise LookupError("config.py defines no class NodeConfig")
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name) and \
                    "ClassVar" not in ast.unparse(stmt.annotation):
                self.fields.append(stmt.target.id)
            elif isinstance(stmt, ast.Assign) and \
                    isinstance(stmt.value, ast.Dict) and \
                    any(isinstance(t, ast.Name) and t.id == "_ENV_MAP"
                        for t in stmt.targets):
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    if isinstance(k, ast.Constant) and \
                            isinstance(v, ast.Constant):
                        self.env_map[k.value] = v.value

    def env_name(self, field: str) -> str:
        return self.env_map.get(field, self.prefix + field.upper())


#: (path, mtime_ns) -> NodeConfigSpec. Three checks read it each run
#: (knob docs, env drift, apply_env parity); the cache parses it once,
#: and the path key keeps fixture trees apart.
_NODE_CONFIG_CACHE: Dict[Tuple[str, int], NodeConfigSpec] = {}


def load_node_config(root: str) -> NodeConfigSpec:
    """NodeConfig's knobs from THIS root's ``config.py`` (never the
    installed package), so a tmp-tree run (the fixture tests) sees the
    tree's own config. Cached per (path, mtime)."""
    path = os.path.join(root, PKG, "config.py")
    key = (os.path.abspath(path), os.stat(path).st_mtime_ns)
    cached = _NODE_CONFIG_CACHE.get(key)
    if cached is None:
        with open(path, encoding="utf-8") as f:
            cached = NodeConfigSpec(ast.parse(f.read()))
        _NODE_CONFIG_CACHE[key] = cached
    return cached


def check_knob_docs(root: str) -> Tuple[List[Finding], int]:
    NodeConfig = load_node_config(root)
    doc_rel = "docs/ops.md"
    doc_path = os.path.join(root, doc_rel)
    fields = NodeConfig.fields
    if not os.path.exists(doc_path):
        return [Finding(code="RTA503", path=doc_rel, line=1,
                        message="missing (the knob table lives here)",
                        anchor="missing")], len(fields)
    with open(doc_path, encoding="utf-8") as f:
        text = f.read()
    findings = []
    for field in fields:
        env = NodeConfig.env_name(field)
        # Delimited-token match, not substring: RAFIKI_TPU_METRICS must
        # not count as documented just because RAFIKI_TPU_METRICS_PORT
        # appears somewhere.
        if not re.search(re.escape(env) + r"(?![A-Z0-9_])", text):
            findings.append(Finding(
                code="RTA503", path=doc_rel, line=1,
                message=f"NodeConfig.{field} ({env}) is "
                        f"undocumented — add it to the knob table",
                anchor=env))
    return findings, len(fields)


# --- RTA504/RTA505: env literal drift + apply_env parity --------------

def _envvars_constants(root: str) -> Set[str]:
    """The ServicesManager-injected identity vars (constants.EnvVars):
    transport plumbing, not operator knobs."""
    path = os.path.join(root, PKG, "constants.py")
    out: Set[str] = set()
    if not os.path.exists(path):
        return out
    with open(path, encoding="utf-8") as f:
        try:
            tree = ast.parse(f.read())
        except SyntaxError:
            return out
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "EnvVars":
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and \
                        isinstance(stmt.value, ast.Constant) and \
                        isinstance(stmt.value.value, str):
                    out.add(stmt.value.value)
    return out


def _env_reads(tree: ast.AST) -> List[Tuple[str, int]]:
    """(env_name, line) for every read of a RAFIKI_TPU_* literal:
    ``*.get("X")``, ``*.getenv("X")``, ``*["X"]`` (Load), and the same
    through a module-level ``CONST = "X"`` indirection."""
    consts: Dict[str, str] = {}
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str) and \
                node.value.value.startswith(ENV_PREFIX):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    consts[tgt.id] = node.value.value

    def resolve(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and \
                node.value.startswith(ENV_PREFIX):
            return node.value
        if isinstance(node, ast.Name):
            return consts.get(node.id)
        return None

    reads: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        name = None
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("get", "getenv", "pop") and node.args:
            name = resolve(node.args[0])
            # .pop with a default is cleanup, not a read the process
            # depends on — but a bare env.pop("X") still names a knob.
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "getenv" and node.args:
            name = resolve(node.args[0])
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load):
            name = resolve(node.slice)
        if name is not None and ENV_NAME_RE.match(name):
            reads.append((name, node.lineno))
    return reads


def check_env_drift(root: str, modules) -> List[Finding]:
    try:
        NodeConfig = load_node_config(root)
        knob_envs = {NodeConfig.env_name(f): f
                     for f in NodeConfig.fields}
    except Exception:
        knob_envs = {}
    identity = _envvars_constants(root)
    findings: List[Finding] = []
    knob_reads: Set[str] = set()
    for rel, text, tree in _parsed_modules(modules):
        if any(rel.startswith(skip) or rel == skip
               for skip in ENV_SCAN_SKIP):
            continue
        if tree is None or ENV_PREFIX not in text:
            continue
        seen_here: Set[str] = set()
        for env, line in _env_reads(tree):
            if env in identity:
                continue
            if env in knob_envs:
                knob_reads.add(env)
                continue
            if env in seen_here:
                continue
            seen_here.add(env)
            findings.append(Finding(
                code="RTA504", path=rel, line=line,
                message=f"env literal {env!r} is read here but is not "
                        f"a NodeConfig knob — operators cannot discover "
                        f"or validate it",
                hint="promote it to a NodeConfig field (env parity + "
                     "apply_env export + docs/ops.md row), or waive "
                     "with why it is internal plumbing",
                anchor=env))

    # RTA505: knobs read by workers must be exported by apply_env.
    exported = _apply_env_exports(root)
    if exported is not None:
        for env in sorted(knob_reads):
            if env not in exported:
                findings.append(Finding(
                    code="RTA505", path=f"{PKG}/config.py",
                    line=exported.get("__line__", 1),
                    message=f"NodeConfig.{knob_envs[env]} ({env}) is "
                            f"read at worker construction but "
                            f"apply_env() never exports it — spawned "
                            f"children may resolve different values "
                            f"than the node validated",
                    hint="export it in apply_env() like the other "
                         "service tunables",
                    anchor=f"apply_env:{env}"))
    return findings


def _field_loops(fn: ast.FunctionDef) -> Dict[str, List[str]]:
    """loop variable -> field names, for each ``for f in ("a", "b"):``
    over a literal tuple or list of strings inside ``apply_env``: the
    port exports groups of knobs that way, and ``self.env_name(f)`` in
    the loop's body exports each of them by name."""
    out: Dict[str, List[str]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.For) and \
                isinstance(node.target, ast.Name) and \
                isinstance(node.iter, (ast.Tuple, ast.List)) and \
                all(isinstance(e, ast.Constant) and isinstance(e.value, str)
                    for e in node.iter.elts):
            out.setdefault(node.target.id, []).extend(
                e.value for e in node.iter.elts)
    return out


def _apply_env_exports(root: str) -> Optional[Dict[str, int]]:
    """Env names apply_env() exports: ``self.env_name("field")`` calls
    and direct literals. Returns None when config.py is unparseable."""
    path = os.path.join(root, PKG, "config.py")
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        try:
            tree = ast.parse(f.read())
        except SyntaxError:
            return None
    try:
        NodeConfig = load_node_config(root)
    except Exception:
        return None
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and \
                node.name == "apply_env":
            out["__line__"] = node.lineno
            loops = _field_loops(node)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr == "env_name" and sub.args:
                    arg = sub.args[0]
                    if isinstance(arg, ast.Constant) and \
                            isinstance(arg.value, str):
                        names = [arg.value]
                    elif isinstance(arg, ast.Name):
                        names = loops.get(arg.id, [])
                    else:
                        names = []
                    for field in names:
                        out[NodeConfig.env_name(field)] = sub.lineno
                elif isinstance(sub, ast.Constant) and \
                        isinstance(sub.value, str) and \
                        sub.value.startswith(ENV_PREFIX):
                    out[sub.value] = sub.lineno
    return out if out else None


# --- the registered checker ------------------------------------------

@register
class DriftChecker(Checker):
    name = "drift"
    codes = ("RTA501", "RTA502", "RTA503", "RTA504", "RTA505",
             "RTA506")
    scope = "repo"
    triggers = (f"{PKG}/*", f"{PKG}/*/*", f"{PKG}/*/*/*",
                "docs/grafana/*", "docs/slo/*", "docs/ops.md")

    def run(self, ctx: RepoContext) -> List[Finding]:
        findings, registered, _ = check_metric_names(ctx.modules)
        dash, _ = check_dashboards(ctx.root, registered)
        findings.extend(dash)
        findings.extend(check_slo_refs(ctx.root, registered,
                                       modules=ctx.modules))
        try:
            knob_findings, _ = check_knob_docs(ctx.root)
            findings.extend(knob_findings)
        except Exception as e:  # config.py unloadable in this tree
            findings.append(Finding(
                code="RTA503", path=f"{PKG}/config.py", line=1,
                message=f"could not load NodeConfig: {e}",
                anchor="load"))
        findings.extend(check_env_drift(ctx.root, modules=ctx.modules))
        return findings
