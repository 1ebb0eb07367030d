"""The checker catalog, machine-readable: one entry per code with what
it flags, the historical bug it encodes, and the fix hint.

``python -m rafiki_torch.analysis --explain RTA104`` prints an entry so
a developer staring at a red gate can self-serve. ``docs/analysis.md``
carries the reference suite's catalog as prose; the port's codes mean
the same except RTA401/RTA402 (torch aliasing in place of jax buffer
donation) and RTA602 (torch in place of jax).
"""

from __future__ import annotations

from typing import Dict

CATALOG: Dict[str, Dict[str, str]] = {
    "RTA000": {
        "title": "unparseable file",
        "flags": "A file under rafiki_torch/ the suite cannot ast.parse.",
        "bug": "A syntax error would otherwise silently shrink the "
               "analyzed surface — every checker would just skip the "
               "file.",
        "hint": "Fix the syntax error; the finding carries the parser "
                "message.",
    },
    "RTA001": {
        "title": "waiver without a reason",
        "flags": "`# rta: disable=CODE` with no reason text.",
        "bug": "A waiver is a reviewed decision; a bare disable is an "
               "escape hatch. Not waivable, by design.",
        "hint": "Say WHY the invariant doesn't apply, on the same "
                "comment.",
    },
    "RTA002": {
        "title": "baseline entry without a reviewed reason",
        "flags": "A baseline.json entry whose reason is empty or still "
                 "the UNREVIEWED placeholder.",
        "bug": "`--update-baseline` must never be silently green; the "
               "placeholder keeps failing until a human writes the "
               "real reason.",
        "hint": "Replace the placeholder with why the finding is "
                "accepted.",
    },
    "RTA003": {
        "title": "stale waiver",
        "flags": "A reasoned `# rta: disable=CODE` comment whose "
                 "finding no longer fires (full runs; under "
                 "--checker scoping only codes a ran checker covers).",
        "bug": "A dead disable rots silently and pre-waives the NEXT "
               "regression on that line — found live in the reference: a "
               "second RTA301 waiver for a label whose one "
               "per-module finding was already anchored (and waived) "
               "elsewhere. Not waivable, by design.",
        "hint": "Delete the comment (the defect was fixed), or fix "
                "the code list if it was a typo.",
    },
    "RTA101": {
        "title": "guarded attribute accessed without its lock",
        "flags": "A class attribute accessed under `with self._lock:` "
                 "somewhere, but read/written lock-free elsewhere "
                 "(outside __init__).",
        "bug": "The ParamStore write-behind row-before-file race: "
               "cross-thread invariants held 'by convention' rot.",
        "hint": "Wrap the access in the guarding lock, or waive with "
                "why the race is benign.",
    },
    "RTA102": {
        "title": "blocking call under a lock (direct)",
        "flags": "sleep/subprocess/socket/open/join/result/queue-op "
                 "called IN the method while a lock is held.",
        "bug": "One time.sleep under the batcher's admission lock "
               "stalls every concurrent client for the duration.",
        "hint": "Snapshot state under the lock, do the slow work after "
                "release. The call-chain form is RTA105.",
    },
    "RTA103": {
        "title": "intra-class lock-order cycle",
        "flags": "Method A takes lock1→lock2, method B takes "
                 "lock2→lock1, within one class (incl. a self-cycle "
                 "on a non-reentrant Lock).",
        "bug": "The two-lock deadlock this class of code grows by "
               "accretion; the cross-class form is RTA104.",
        "hint": "Pick ONE acquisition order and restructure the other "
                "path.",
    },
    "RTA104": {
        "title": "cross-class lock-order cycle (interprocedural)",
        "flags": "Two classes' locks acquired in opposite orders on "
                 "two program paths — followed through the repo-wide "
                 "call graph, across modules, any number of frames "
                 "deep (bounded).",
        "bug": "The breaker reset and promote double-alloc "
               "were cross-OBJECT races invisible to per-class "
               "analysis; this is the deadlock-shaped sibling.",
        "hint": "Pick one global order for the two classes (document "
                "it), or hand off through a queue so one side never "
                "holds its lock into the other.",
    },
    "RTA105": {
        "title": "blocking reached through the call graph under a lock",
        "flags": "A method holds a lock while calling a chain that — "
                 "frames later, possibly in another module — sleeps, "
                 "does disk/socket I/O, or a bus round-trip.",
        "bug": "The promote path blocks under the node-wide "
               "promote lock ACROSS a registration wait (deliberate, "
               "waived) — review had to find every accidental sibling "
               "by hand until this code existed.",
        "hint": "Release the lock before the slow call (snapshot "
                "under the lock, act after), or waive with why the "
                "stall is acceptable; the finding prints the frame "
                "chain.",
    },
    "RTA106": {
        "title": "cross-thread-root unguarded shared state",
        "flags": "An attribute written from one thread root "
                 "(Thread target / executor submit / HTTP handler) "
                 "and accessed from another, with NO lock anywhere on "
                 "that attribute.",
        "bug": "The circuit-breaker class: state shared between "
               "the persist thread and the trial loop with nothing "
               "enforcing the ordering either side assumed.",
        "hint": "Guard both sides with one lock or hand over through "
                "a Queue/Event; waive only with the reason the race "
                "is benign (monotonic flag, GIL-atomic scalar).",
    },
    "RTA201": {
        "title": "thread neither daemonized nor joined",
        "flags": "threading.Thread(...) without daemon=True and "
                 "without a .join() on any stop/close/drain path.",
        "bug": "The _PersistStage/batcher/write-behind pattern "
               ": a non-daemon, never-joined thread wedges "
               "interpreter shutdown.",
        "hint": "Pass daemon=True, or join from stop()/close()/"
                "drain().",
    },
    "RTA202": {
        "title": "executor never shut down",
        "flags": "A concurrent.futures executor bound to self.X with "
                 "no self.X.shutdown(...) in the class.",
        "bug": "Same lifecycle class as RTA201, executor flavor.",
        "hint": "Add shutdown(wait=True) to the close/stop path.",
    },
    "RTA301": {
        "title": "dynamic metric label without .remove()",
        "flags": "A series sample with a non-literal label value and "
                 "no matching .remove(...) in the module.",
        "bug": "The leak: per-trial/per-instance series lived "
               "forever in the process registry.",
        "hint": "Call <metric>.remove(label=value) from the owner's "
                "stop/close/trial-end path, or waive with the bounded "
                "label vocabulary.",
    },
    "RTA401": {
        "title": "cache-resident tensor written or aliased",
        "flags": "A value that came from a staging/residency cache "
                 "(taint flows through helper returns) written in "
                 "place (a `*_` method such as copy_/add_/zero_, an "
                 "out= argument, a subscript store, an augmented "
                 "assignment), or a cache-tainted or cache-bound value "
                 "made by torch.from_numpy/as_tensor/asarray/frombuffer "
                 "instead of copied.",
        "bug": "F7: the host dataset cache shares one read-only set "
               "among trials, and on the CPU "
               "torch.from_numpy(ds.images).to(device) is that array's "
               "own memory — a write to the staged tensor would change "
               "every later trial's data under an unchanged "
               "fingerprint.",
        "hint": "Copy into a cache (torch.tensor(a, device=...)) and "
                "write only into tensors no cache holds.",
    },
    "RTA402": {
        "title": "CUDA graph's static output escapes",
        "flags": "A method that replays a CUDA graph returns or stores "
                 "an attribute assigned inside the graph's capture "
                 "(directly or through a captured local) itself, "
                 "rather than a copy.",
        "bug": "The next replay overwrites the static output in place: "
               "a caller still holding the previous result reads the "
               "next batch's — on the card only, i.e. never in CPU CI. "
               "PredictRunner returns a .clone() for that reason.",
        "hint": "Return or keep .clone(), or waive with why every "
                "reader is done before the next replay.",
    },
    "RTA501": {
        "title": "metric name off-contract",
        "flags": "A registered name not matching "
                 "rafiki_tpu_<subsystem>_<name>_<unit>.",
        "bug": "One typo'd name forks the namespace forever.",
        "hint": "Fix the name, or extend the vocabulary in "
                "checkers/drift.py deliberately.",
    },
    "RTA502": {
        "title": "dashboard references unregistered metric",
        "flags": "A rafiki_tpu_* token in a Grafana JSON no code "
                 "registers.",
        "bug": "A renamed series silently blanks a panel.",
        "hint": "Update the dashboard (or restore the name).",
    },
    "RTA503": {
        "title": "undocumented NodeConfig knob",
        "flags": "A NodeConfig env var missing from docs/ops.md's "
                 "knob table.",
        "bug": "The audit found three generations of undocumented "
               "knobs.",
        "hint": "Add the docs/ops.md row.",
    },
    "RTA504": {
        "title": "ad-hoc env knob",
        "flags": "A RAFIKI_TPU_* literal read anywhere that is not a "
                 "NodeConfig field or injected identity var.",
        "bug": "Ad-hoc os.environ knobs bypass validation, precedence "
               "and the docs gate — how the audit's three "
               "undocumented generations happened.",
        "hint": "Promote to a NodeConfig field (validation + "
                "apply_env + ops.md row), or baseline with why it "
                "must stay env-only.",
    },
    "RTA505": {
        "title": "knob read by workers but not exported",
        "flags": "A NodeConfig knob read at worker construction that "
                 "apply_env() never exports.",
        "bug": "Spawned children resolve different values than the "
               "node validated.",
        "hint": "Export it in apply_env() like the other tunables.",
    },
    "RTA506": {
        "title": "SLO plane references unregistered metric",
        "flags": "A metric name in the SLO consumed-series vocabulary "
                 "(observe/slo.py, admin/slo_engine.py) or in a "
                 "docs/slo/ rules file that no code path registers.",
        "bug": "A renamed source series silently blanks every "
               "objective that reads it — no data means no burn, "
               "which reads as 'SLO healthy' during an outage ("
               "the RTA502 class, pointed at the judgment layer).",
        "hint": "Fix the consumed-series name / rules file (or "
                "restore the registered name).",
    },
    "RTA601": {
        "title": "side effect at import time",
        "flags": "A thread built/started, socket/server bound, "
                 "process spawned, or environment variable read by "
                 "module-level (or class-body) code.",
        "bug": "Every subprocess service runner re-executes module "
               "import effects in ITS process; the NODE_LEASE "
               "class-attribute read froze its value at first import, "
               "BEFORE apply_env could export the validated one "
               "(fixed since).",
        "hint": "Move the effect into the function/constructor that "
                "needs it; env belongs in NodeConfig or a "
                "construction-time read.",
    },
    "RTA602": {
        "title": "eager torch import on the bus/broker path",
        "flags": "A module-level torch/triton import in any module "
                 "import-time-reachable from rafiki_torch/bus/.",
        "bug": "observe/__init__ lazy-loads profiling (the one observe "
               "module that imports torch) precisely so brokers never "
               "pay a torch import (seconds + a CUDA runtime they must "
               "not touch).",
        "hint": "Import inside the function that needs it (the "
                "observe/__init__ pattern), or break the module edge "
                "from the bus path; the finding prints the import "
                "chain.",
    },
    "RTA701": {
        "title": "bus queue-flow drift (orphan producer / dead "
                 "consumer)",
        "flags": "A queue-name family (the literal, or an f-string's "
                 "literal prefix, through the first ':') pushed with "
                 "no in-tree popper, or popped with no in-tree "
                 "pusher; and a control-frame op token (__drain__ "
                 "style) produced without a dispatcher or vice "
                 "versa. Names forwarded through a helper's `queue` "
                 "parameter resolve through the call graph to the "
                 "real producer/consumer.",
        "bug": "The bus is stringly-typed: renaming the worker input "
               "queue on ONE side (cache push vs worker pop) "
               "deadlocks serving with every unit test green — the "
               "exact defect class the continuous-batching reply "
               "queues (`r:`) and advisor RPC queues (`adv:`) ship "
               "more of every PR.",
        "hint": "Spell both sides from one shared helper/constant; "
                "fully dynamic names (empty f-string prefix) are "
                "exempt by design — prefer a literal family prefix "
                "so the checker can see the seam.",
    },
    "RTA702": {
        "title": "HTTP route drift (caller vs served route table)",
        "flags": "An in-tree HTTP caller (client SDK `_call`, "
                 "autoscaler/SLO `fetch` scrapes, peer "
                 "urlopen/Request probes, session uploads, dashboard "
                 "`api(...)`) whose method+path matches no served "
                 "route tuple; or a served route no in-tree caller "
                 "ever hits (waivable for operator-only surfaces). "
                 "Dynamic path segments are wildcards on both sides.",
        "bug": "The predictor admin split moved `/services/<id>/...` "
               "handlers between apps more than once; a typo'd "
               "client path 404s only at runtime, and a dead route "
               "is untested attack surface that drifts silently.",
        "hint": "Fix the caller's spelling or register the route; "
                "for deliberately caller-less routes (health/debug "
                "surfaces) waive at the route tuple with the reason.",
    },
    "RTA703": {
        "title": "feature-flag off-path side effect",
        "flags": "For a declared default-off flag (flow.FLAG_REGISTRY"
                 "; seeded with RAFIKI_TPU_CLUSTER_FABRIC): a thread "
                 "spawn, metric-series registration, bus subscription "
                 "loop, or socket open reachable from import or "
                 "construction without passing the flag gate — an "
                 "ungated import-time effect in a flag-owned module, "
                 "an ungated constructor call of a flag-owned class, "
                 "an effect in an unprotected flag-owned function, "
                 "or a flag-owned metric series registered ungated.",
        "bug": "Disabled-means-free is a hard invariant: a "
               "scrape with the fabric flag off must show ZERO "
               "fabric series and spawn zero fabric threads; one "
               "ungated NodeRegistry construction silently puts the "
               "whole fleet's off-path on the fabric heartbeat.",
        "hint": "Gate the effect (or every call site of its "
                "function) with the flag; new default-off subsystems "
                "must add their entry to flow.FLAG_REGISTRY.",
    },
}


def explain(code: str) -> str:
    """The --explain rendering for one code (KeyError on unknown —
    the CLI validates first)."""
    e = CATALOG[code]
    return (f"{code} — {e['title']}\n\n"
            f"  flags : {e['flags']}\n"
            f"  bug   : {e['bug']}\n"
            f"  fix   : {e['hint']}\n")
