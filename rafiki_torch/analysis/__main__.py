"""CLI: ``python -m rafiki_torch.analysis [--changed] [--json]
[--update-baseline]``.

Exit 0 = no NEW findings (everything is fixed, waived with a reason,
or frozen in the committed baseline); exit 1 otherwise. ``--changed``
scopes per-file checkers to files touched since the merge-base with
main (plus uncommitted work) for fast pre-commit runs; repo-scope
checkers still run when one of their trigger files changed.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import core


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m rafiki_torch.analysis",
        description="Repo-native static analysis suite "
                    "(docs/analysis.md)")
    parser.add_argument("--root", default=None,
                        help="repo root (default: this checkout)")
    parser.add_argument("--changed", action="store_true",
                        help="only analyze files changed vs the "
                             "merge-base with main + uncommitted work")
    parser.add_argument("--diff", metavar="BASE", default=None,
                        help="incremental mode vs an explicit git "
                             "base (commit/ref): file-local checkers "
                             "see only changed files, whole-program "
                             "checkers still run on the full model "
                             "when triggered; prints per-checker "
                             "wall time")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit the full machine-readable report")
    parser.add_argument("--update-baseline", action="store_true",
                        help="freeze current findings into the "
                             "baseline (keeps existing reasons; new "
                             "entries get an UNREVIEWED placeholder "
                             "that still fails)")
    parser.add_argument("--baseline", default=None,
                        help="baseline file (default: the committed "
                             f"{core.PKG}/analysis/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline (report everything)")
    parser.add_argument("--checker", action="append", default=None,
                        help="run only this checker (repeatable); "
                             "names: " + ", ".join(
                                 c.name for c in core.all_checkers()))
    parser.add_argument("--explain", metavar="CODE", default=None,
                        help="print the catalog entry + fix hint for "
                             "one RTA code and exit (self-serve on a "
                             "red gate)")
    args = parser.parse_args(argv)
    if args.explain is not None:
        from .catalog import CATALOG, explain

        code = args.explain.strip().upper()
        if code not in CATALOG:
            parser.error("unknown code %s (known: %s)"
                         % (code, ", ".join(sorted(CATALOG))))
        print(explain(code))
        return 0
    if args.checker:
        known = {c.name for c in core.all_checkers()}
        bad = sorted(set(args.checker) - known)
        if bad:
            # An unknown name would otherwise filter out EVERY checker
            # and exit 0 — a typo'd CI invocation must not go green.
            parser.error("unknown checker(s): %s (names: %s)"
                         % (", ".join(bad), ", ".join(sorted(known))))
    if args.update_baseline and (args.changed or args.checker
                                 or args.diff):
        # A scoped run never produces findings for unscanned files or
        # checkers, so rewriting the baseline from it would silently
        # drop every frozen entry outside the scope.
        parser.error("--update-baseline requires a full run "
                     "(drop --changed/--checker/--diff)")
    if args.changed and args.diff:
        parser.error("--changed and --diff are the same mode with "
                     "different bases; pick one")

    root = args.root or core.repo_root()
    bl_path = args.baseline or core.baseline_path()
    baseline = {} if args.no_baseline else core.load_baseline(bl_path)
    changed = None
    if args.diff is not None:
        changed = core.changed_files(root, base=args.diff)
    elif args.changed:
        changed = core.changed_files(root)

    report = core.run_suite(root, changed=changed, baseline=baseline,
                            only=args.checker)

    if args.update_baseline:
        n = core.save_baseline(bl_path, report.findings, baseline)
        print(f"baseline: wrote {n} entries to {bl_path}", file=sys.stderr)
        # Re-classify against what was just written so the printed
        # report (and exit code) reflect the new baseline — entries
        # with an UNREVIEWED placeholder still fail via RTA002.
        report = core.run_suite(root, changed=changed,
                                baseline=core.load_baseline(bl_path),
                                only=args.checker)

    if args.as_json:
        print(json.dumps(report.to_json(), indent=1))
    else:
        for f in sorted(report.new,
                        key=lambda f: (f.path, f.line, f.code)):
            print(f.render())
        n_waived = sum(1 for f in report.findings
                       if f.status == "waived")
        n_base = sum(1 for f in report.findings
                     if f.status == "baselined")
        if report.stale_baseline:
            print(f"note: {len(report.stale_baseline)} stale baseline "
                  f"entr{'y' if len(report.stale_baseline) == 1 else 'ies'} "
                  f"(fixed findings — run --update-baseline to prune):",
                  file=sys.stderr)
            for ident in report.stale_baseline:
                print(f"  {ident}", file=sys.stderr)
        verdict = ("ok" if not report.new else
                   f"{len(report.new)} new finding(s)")
        print(f"{verdict}: {report.n_files} files, "
              f"{len(report.findings)} findings "
              f"({n_base} baselined, {n_waived} waived) "
              f"[checkers: {', '.join(report.checkers)}]")
        if args.diff is not None:
            times = "  ".join(f"{k} {v:.2f}s" for k, v in
                              sorted(report.timings.items(),
                                     key=lambda kv: -kv[1]))
            print(f"timings: {times}", file=sys.stderr)
    return 1 if report.new else 0


if __name__ == "__main__":
    sys.exit(main())
