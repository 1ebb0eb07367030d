"""CLI: run a node of the platform.

The port's copy of ``rafiki_tpu/__main__.py``, with its arguments and
checks:

    python -m rafiki_torch serve --workdir /var/rafiki --port 3000 \\
        [--bus tcp://host:6380]
    python -m rafiki_torch broker --port 6380 [--python]
    python -m rafiki_torch join --workdir /var/rafiki \\
        --bus tcp://host:6380 (--train-job ID | --inference-job ID)

``serve`` runs the admin REST service and the node's services (threads
on its cards) until SIGINT or SIGTERM; it prints the card's name, then
the admin's URL. ``broker`` runs a bus broker, the C++ one when g++
builds it, else the Python one, and says which. ``join`` is a second
node sharing a primary's workdir and TCP bus: it attaches one train
worker per sub-job of a running train job, or one serving replica per
bin of a running inference job, on its own cards, and leaves when the
job is done (or at ``--timeout``), stopping what it launched.

A node runs on CUDA; ``RAFIKI_TPU_PLATFORM=cpu`` runs it, and the
service processes it spawns, on the CPU (the tests). Without a card and
without that, it raises. ``--coordinator``, ``--num-processes`` and
``--process-id`` (all three, or none) make ``serve`` one process of a
node over several (ref :54-60): it joins the process group
(``parallel.dist.initialize``) before the platform is built, so the chip
allocator sizes from the global device list, prints
``rafiki-tpu process group: process I of N, GLOBAL G LOCAL L, backend
B``, and leaves the group at shutdown.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import socket
import sys
import threading
import time


def _platform_line(device) -> str:
    """The reference's platform line, naming the card (or the CPU)."""
    if device.type == "cuda":
        import torch

        name = torch.cuda.get_device_name(device)
    else:
        name = "cpu"
    return f"rafiki-tpu platform: {name}"


def _exit_on_sigterm() -> None:
    """SIGTERM exits through ``SystemExit``, so ``finally`` blocks (the
    platform's shutdown) run."""
    signal.signal(signal.SIGTERM,
                  lambda signum, _frame: sys.exit(128 + signum))


def _serve(args: argparse.Namespace) -> None:
    # One validated config a node: the CLI's arguments, then the
    # RAFIKI_TPU_* variables, then the defaults; the tunables are
    # exported back, so the services this node starts read the same.
    from .config import NodeConfig

    cfg = NodeConfig.from_env(
        workdir=args.workdir, port=args.port, n_chips=args.chips,
        bus_uri=args.bus, log_level=args.log_level,
        coordinator=args.coordinator or None,
        num_processes=args.num_processes, process_id=args.process_id)
    cfg.apply_env()
    logging.basicConfig(
        level=getattr(logging, cfg.log_level.upper()),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    from .torchenv import env_device

    device = env_device()
    print(_platform_line(device), flush=True)

    # A node over several processes: every process runs serve with the
    # same coordinator; the group forms before the platform, whose chip
    # allocator then sizes from the global device list (ref :54-60).
    from .parallel import dist

    if cfg.coordinator:
        node = dist.initialize(cfg.coordinator, cfg.num_processes,
                               cfg.process_id)
        print(f"rafiki-tpu process group: process {node.process_index} "
              f"of {node.num_processes}, GLOBAL {len(node.devices)} "
              f"LOCAL {len(node.local)}, backend {node.backend}",
              flush=True)
    try:
        from .platform import LocalPlatform

        platform = LocalPlatform.from_config(cfg, http=True, device=device)
        app = platform.app
        print(f"rafiki-tpu admin on http://{app.host}:{app.port} "
              f"(workdir={platform.workdir})", flush=True)

        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        try:
            stop.wait()
        finally:
            print("shutting down...", flush=True)
            platform.shutdown()
    finally:
        dist.shutdown()


def _join(args: argparse.Namespace) -> None:
    """A worker node: capacity attached to a running job. It shares the
    primary's meta store (``--workdir`` on a shared filesystem), params
    directory and TCP bus; its train workers take proposals from the
    job's advisor service, so the search stays one search."""
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if not args.bus:
        raise SystemExit("join needs --bus tcp://host:port (the primary "
                         "node's broker): an in-process bus cannot span "
                         "nodes")

    from .torchenv import env_device

    device = env_device()
    print(_platform_line(device), flush=True)
    _exit_on_sigterm()

    from .platform import LocalPlatform

    # The workdir is the primary's, so the node names itself (the
    # workdir's stable id is the primary's); shutdown stops this node's
    # services, so a departing joiner leaves no RUNNING row behind.
    platform = LocalPlatform(workdir=args.workdir, http=False,
                             n_chips=args.chips, bus_uri=args.bus,
                             device=device, stop_jobs_on_shutdown=False,
                             node_id=f"{socket.gethostname()}"
                                     f"/join-{os.getpid()}",
                             adopt_unowned=False)
    try:
        if args.train_job:
            attached = platform.admin.attach_workers(
                args.train_job, chips_per_trial=args.chips_per_trial)
            if not attached:
                raise SystemExit("no chips available on this node")
            print(f"attached {len(attached)} worker(s) to "
                  f"{args.train_job}", flush=True)
            ok = platform.admin.wait_until_train_job_done(
                args.train_job, timeout=args.timeout)
            print("train job done" if ok else "timed out waiting",
                  flush=True)
            if not ok:
                raise SystemExit(1)
        else:
            # Serving replicas: more copies of the served bins on this
            # node; the predictor shards each bin's slice over them.
            attached = platform.admin.attach_inference_workers(
                args.inference_job,
                chips_per_worker=args.chips_per_trial)
            if not attached:
                raise SystemExit("no chips available on this node")
            print(f"attached {len(attached)} replica worker(s) to "
                  f"{args.inference_job}", flush=True)
            deadline = time.monotonic() + args.timeout
            while time.monotonic() < deadline:
                job = platform.meta.get_inference_job(args.inference_job)
                if job is None or job["status"] != "RUNNING":
                    print("inference job stopped", flush=True)
                    break
                time.sleep(2.0)
            else:
                # Leaving at the timeout takes this node's replicas down
                # mid-serve: say so.
                print("timed out while the inference job is still "
                      "RUNNING; withdrawing this node's replicas",
                      flush=True)
                raise SystemExit(1)
    finally:
        platform.shutdown()


def _broker(args: argparse.Namespace) -> None:
    from .bus import NativeBusServer, serve_broker

    server = serve_broker(args.host, args.port,
                          native=False if args.python else None)
    kind = type(server).__name__
    if isinstance(server, NativeBusServer):
        how = (f"built by g++ in {server.build_s:.2f} s"
               if server.build_s else "binary already built")
        print(f"native broker: {how}", flush=True)
    print(f"bus broker ({kind}) on {server.uri}", flush=True)
    # SIGTERM ends the broker as SIGINT does.
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        if isinstance(server, NativeBusServer):
            server.serve_forever()  # raises if the child broker crashes
        else:
            # The Python broker serves on its own thread: just block.
            threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="rafiki_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    # None = not given on the command line: NodeConfig.from_env then
    # takes the RAFIKI_TPU_* variable, then its default.
    serve = sub.add_parser("serve", help="run an admin and worker node")
    serve.add_argument("--workdir", default=None,
                       help="state directory (sqlite meta + params)")
    serve.add_argument("--port", type=int, default=None)
    serve.add_argument("--chips", type=int, default=None,
                       help="limit to the first N cards (default: all)")
    serve.add_argument("--bus", default=None,
                       help="bus URI ('' = in-process; 'tcp://host:port')")
    serve.add_argument("--log-level", default=None)
    serve.add_argument("--coordinator", default=None,
                       help="coordinator host:port of a node over several "
                            "processes (process 0 listens there)")
    serve.add_argument("--num-processes", type=int, default=None,
                       help="processes of the node")
    serve.add_argument("--process-id", type=int, default=None,
                       help="this process's rank")
    serve.set_defaults(fn=_serve)

    join = sub.add_parser(
        "join", help="attach this node's cards to a running job "
                     "(shared workdir + tcp bus)")
    join.add_argument("--workdir", required=True,
                      help="the PRIMARY node's state directory "
                           "(shared filesystem)")
    join.add_argument("--bus", required=True,
                      help="primary node's bus URI (tcp://host:port)")
    join.add_argument("--train-job", default=None,
                      help="attach train workers to this RUNNING job")
    join.add_argument("--inference-job", default=None,
                      help="attach serving REPLICA workers to this "
                           "RUNNING inference job")
    join.add_argument("--chips", type=int, default=None,
                      help="limit to the first N local cards")
    join.add_argument("--chips-per-trial", type=int, default=1)
    join.add_argument("--timeout", type=float, default=3600.0)
    join.add_argument("--log-level", default="info")
    join.set_defaults(fn=_join)

    broker = sub.add_parser(
        "broker", help="run a standalone bus broker (nodes in several "
                       "processes or hosts point --bus at it)")
    broker.add_argument("--host", default="127.0.0.1")
    broker.add_argument("--port", type=int, default=6380)
    broker.add_argument("--python", action="store_true",
                        help="force the Python broker (default: the C++ "
                             "broker when a toolchain exists)")
    broker.set_defaults(fn=_broker)
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cmd == "join":
        if bool(args.train_job) == bool(args.inference_job):
            parser.error("give exactly one of --train-job / "
                         "--inference-job")
    if args.cmd == "serve":
        n_set = sum([args.coordinator is not None,
                     args.num_processes is not None,
                     args.process_id is not None])
        if n_set not in (0, 3):
            parser.error(
                "--coordinator, --num-processes and --process-id must be "
                "given together (all three, or none)")
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
