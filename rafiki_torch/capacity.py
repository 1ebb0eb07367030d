"""``python -m rafiki_torch.capacity``: the capacity engine's CLI.

``score``
    Simulate a trace (a recorded ``workload.jsonl`` or log directory, or
    a canned name: zipf, ramp, chaos) under a candidate autoscale policy
    and SLO rules, and print the JSON report. Exits 0 when every
    objective held and 1 when any fired::

        python -m rafiki_torch.capacity score --trace ramp \\
            --policy '{"queue_high": 0.5}'

``learn``
    Fold a recorded trace into a phase-binned periodicity table for the
    autoscaler's predictive plane
    (``RAFIKI_TPU_AUTOSCALE_PERIODICITY``)::

        python -m rafiki_torch.capacity learn --trace logs/ \\
            --period 86400 --bin 300 --out periodicity.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional


def _load_json_arg(value: str, what: str) -> Dict[str, Any]:
    """Inline JSON (starts with ``{``) or a path to a JSON file."""
    try:
        if value.lstrip().startswith("{"):
            data = json.loads(value)
        else:
            with open(value, "r", encoding="utf-8") as f:
                data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"{what} {value!r}: {e}") from None
    if not isinstance(data, dict):
        raise ValueError(f"{what} {value!r}: expected a JSON object")
    return data


def _cmd_score(args: argparse.Namespace) -> int:
    from .admin import capacity
    from .observe import replay, slo

    trace = capacity.resolve_trace(args.trace)
    policy = capacity.make_policy(
        _load_json_arg(args.policy, "policy") if args.policy else None)
    objectives = slo.parse_rules(args.slo) if args.slo is not None \
        else None
    fleet = None
    if args.fleet:
        with open(args.fleet, "r", encoding="utf-8") as f:
            fleet = replay.FleetModel.from_exposition(f.read())
        if fleet is None:
            raise ValueError(
                f"fleet exposition {args.fleet!r} has no "
                f"{replay.FLEET_SOURCE_SERIES} samples to fit from")
    sim = replay.SimKnobs(seed=args.seed,
                          sweep_interval_s=args.sweep_interval,
                          queue_cap=args.queue_cap,
                          provision_delay_s=args.provision_delay)
    periodicity = capacity.load_periodicity(args.periodicity) \
        if args.periodicity else None
    report = capacity.score(trace, policy=policy,
                            objectives=objectives, fleet=fleet,
                            sim=sim, periodicity=periodicity)
    if not args.full:
        # The timeline and full decision log are debugging surfaces;
        # the gate verdict + quantiles are the CI-facing record.
        report.pop("replica_timeline", None)
        report["decisions"] = report["decisions"][-20:]
    json.dump(report, sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")
    return 0 if report["ok"] else 1


def _cmd_learn(args: argparse.Namespace) -> int:
    from .admin import capacity

    trace = capacity.resolve_trace(args.trace)
    table = capacity.learn_periodicity(trace, period_s=args.period,
                                       bin_s=args.bin)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(table, f, indent=2, sort_keys=True)
            f.write("\n")
    else:
        json.dump(table, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m rafiki_torch.capacity",
        description="Trace-replay capacity engine")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("score",
                       help="simulate a trace under a policy; exit 1 "
                            "on any SLO violation")
    p.add_argument("--trace", required=True,
                   help="workload.jsonl / log dir, or canned: "
                        "zipf | ramp | chaos")
    p.add_argument("--policy", default=None,
                   help="candidate PolicyKnobs as inline JSON or a "
                        "JSON file (default: the shipped defaults)")
    p.add_argument("--slo", default=None,
                   help="SLO rules (inline grammar or rules file; "
                        "default: the canned gate rules)")
    p.add_argument("--fleet", default=None,
                   help="a saved /metrics exposition to fit per-bin "
                        "service times from (default: fit from the "
                        "trace's own compute_ms when recorded, else "
                        "synthetic)")
    p.add_argument("--periodicity", default=None,
                   help="learned periodicity table for the predictive "
                        "plane")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sweep-interval", type=float, default=1.0)
    p.add_argument("--queue-cap", type=float, default=64.0)
    p.add_argument("--provision-delay", type=float, default=2.0)
    p.add_argument("--full", action="store_true",
                   help="keep the full replica timeline and decision "
                        "log in the report")
    p.set_defaults(func=_cmd_score)

    p = sub.add_parser("learn",
                       help="learn a periodicity table from a trace")
    p.add_argument("--trace", required=True)
    p.add_argument("--period", type=float, required=True,
                   help="the recurrence period, seconds")
    p.add_argument("--bin", type=float, default=60.0,
                   help="phase bin width, seconds")
    p.add_argument("--out", default=None,
                   help="write the table here (default: stdout)")
    p.set_defaults(func=_cmd_learn)

    args = parser.parse_args(argv)
    try:
        return args.func(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
