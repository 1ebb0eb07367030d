"""Service entry points: a service's environment -> its worker object.

The port's copy of ``rafiki_tpu/container/services.py``.
``build_service`` reads ``EnvVars.SERVICE_TYPE`` and builds the train
worker, advisor service, inference worker or predictor service, each
bound to the chip group its environment names (``EnvVars.CHIPS``) on
the context's device type. The thread runtime calls it in-process on
the platform's shared context; a service process runs ``main`` (``python
-m rafiki_torch.container.services``), which opens the stores and the
bus the environment names (``SystemContext.from_env``) on the device
``RAFIKI_TPU_PLATFORM`` names: unset means CUDA, and a process without
a card then raises, never carrying on on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

from ..bus import BaseBus, connect
from ..constants import BudgetOption, EnvVars, ServiceType
from ..parallel.chips import ChipGroup
from ..store import MetaStore, ParamStore


@dataclass
class SystemContext:
    """The shared substrate every service programs against;
    ``device_type`` is ``"cuda"``, or ``"cpu"`` for a platform asked to
    run on the CPU."""

    meta: MetaStore
    params: ParamStore
    bus: BaseBus
    device_type: str = "cuda"

    @staticmethod
    def from_env(env: Mapping[str, str]) -> "SystemContext":
        """The stores, the bus and the device a service process's
        environment names; the device resolves first, so a process
        without the card it was given raises before it opens anything."""
        from ..torchenv import env_device

        device_type = env_device(env).type
        return SystemContext(
            meta=MetaStore(env[EnvVars.META_URI]),
            params=ParamStore(env[EnvVars.PARAMS_DIR]),
            bus=connect(env.get(EnvVars.BUS_URI, "")),
            device_type=device_type)


def build_service(env: Mapping[str, str],
                  ctx: Optional[SystemContext] = None) -> Any:
    """Construct (not start) the worker object for a service env;
    without ``ctx``, on the context the environment names."""
    ctx = ctx or SystemContext.from_env(env)
    service_type = env[EnvVars.SERVICE_TYPE]
    service_id = env[EnvVars.SERVICE_ID]
    chips = (ChipGroup.from_env(env[EnvVars.CHIPS], ctx.device_type)
             if env.get(EnvVars.CHIPS) else None)
    service = _build(service_type, service_id, env, ctx, chips)
    # A thread service writes its records to its own file (bound by the
    # worker when it runs).
    if env.get(EnvVars.LOG_DIR):
        from ..utils.service_logs import service_log_path

        service.log_path = service_log_path(env[EnvVars.LOG_DIR],
                                            service_id)
    return service


def _build(service_type: str, service_id: str, env: Mapping[str, str],
           ctx: SystemContext, chips: Optional[ChipGroup]) -> Any:
    if service_type == ServiceType.TRAIN:
        from ..worker.train import TrainWorker

        return TrainWorker(service_id, env[EnvVars.SUB_TRAIN_JOB_ID],
                           ctx.meta, ctx.params, ctx.bus, chips=chips,
                           device=ctx.device_type)
    if service_type == ServiceType.ADVISOR:
        return _build_advisor_service(env[EnvVars.SUB_TRAIN_JOB_ID], ctx)
    if service_type == ServiceType.INFERENCE:
        from ..worker.inference import BusInferenceWorker

        return BusInferenceWorker(
            service_id, env[EnvVars.INFERENCE_JOB_ID],
            env[EnvVars.TRIAL_ID], ctx.meta, ctx.params, ctx.bus,
            chips=chips, device=ctx.device_type, node=_fabric_node(env))
    if service_type == ServiceType.PREDICT:
        from ..predictor.app import PredictorService

        return PredictorService.for_job(
            service_id, env[EnvVars.INFERENCE_JOB_ID], ctx.meta, ctx.bus,
            port=int(env.get("RAFIKI_TPU_PORT", "0")),
            node=_fabric_node(env))
    raise ValueError(f"unknown service type: {service_type!r}")


def _fabric_node(env: Mapping[str, str]) -> str:
    """The placing node's id, which a serving service uses only on the
    cluster fabric ("" off it)."""
    from ..config import cluster_fabric_enabled

    return env.get(EnvVars.NODE_ID, "") if cluster_fabric_enabled() else ""


def _build_advisor_service(sub_id: str, ctx: SystemContext) -> Any:
    """The ``AdvisorWorker`` of one sub-train-job: its model's knob
    space, its advisor type and its trial budget; an ENAS controller
    runs on the context's device type."""
    from ..advisor import make_advisor
    from ..advisor.worker import AdvisorWorker
    from ..utils.model_loader import load_model_class

    sub = ctx.meta.get_sub_train_job(sub_id)
    job = ctx.meta.get_train_job(sub["train_job_id"])
    model_row = ctx.meta.get_model(sub["model_id"])
    model_class = load_model_class(model_row["model_class"],
                                   model_row.get("model_source"))
    advisor = make_advisor(
        model_class.get_knob_config(), advisor_type=sub.get("advisor_type"),
        total_trials=job["budget"].get(BudgetOption.MODEL_TRIAL_COUNT),
        device=ctx.device_type)
    return AdvisorWorker(advisor, ctx.bus, sub_id)


def main() -> None:
    """A service process's entry: build the service from
    ``os.environ`` and run it in the foreground until SIGTERM stops it.
    The process log, the span sink and the workload sink go to
    ``RAFIKI_TPU_LOG_DIR``; ``RAFIKI_TPU_METRICS_PORT`` starts a
    metrics-only server, whose bound address is advertised in
    ``RAFIKI_TPU_METRICS_ADDR``."""
    import logging
    import os
    import signal
    import socket

    from ..torchenv import env_device

    # The device first: a process without the card it was given raises
    # here, before it opens a store or the bus.
    env_device()
    env = dict(os.environ)
    log = logging.getLogger(__name__)
    if env.get(EnvVars.LOG_DIR):
        from ..observe import trace
        from ..observe import workload
        from ..utils.service_logs import (attach_process_log,
                                          service_log_path)

        # The whole process is the service: one file handler takes
        # every thread's records.
        attach_process_log(service_log_path(env[EnvVars.LOG_DIR],
                                            env[EnvVars.SERVICE_ID]))
        # The shared <log_dir>/spans.jsonl: appended lines interleave
        # safely with the admin's process and the sibling services.
        trace.configure(env[EnvVars.LOG_DIR])
        workload.configure(env[EnvVars.LOG_DIR])
        # The root handler owns the file now; without the variable
        # build_service binds no thread handler to it as well.
        env.pop(EnvVars.LOG_DIR)
    metrics_port = env.get("RAFIKI_TPU_METRICS_PORT")
    if metrics_port:
        from ..observe import metrics

        if not metrics.metrics_enabled():
            log.warning("RAFIKI_TPU_METRICS_PORT=%s ignored: "
                        "RAFIKI_TPU_METRICS disables metrics for this "
                        "process", metrics_port)
        else:
            try:
                server = metrics.serve_metrics(
                    port=int(metrics_port),
                    name=f"metrics-{env.get(EnvVars.SERVICE_ID, '?')[:8]}")
                log.info("metrics server on port %d", server.port)
                try:
                    host = socket.gethostbyname(socket.gethostname())
                except OSError:
                    host = "127.0.0.1"
                os.environ[EnvVars.METRICS_ADDR] = f"{host}:{server.port}"
            except (OSError, ValueError):
                # A port taken by a sibling service (or a malformed one)
                # leaves the service without metrics, never without work.
                log.warning("metrics server on port %s unavailable; "
                            "continuing without", metrics_port,
                            exc_info=True)
    ctx = SystemContext.from_env(env)
    service = build_service(env, ctx)
    stop = getattr(service, "stop", None)
    if stop is not None:
        signal.signal(signal.SIGTERM, lambda *_: stop())
    try:
        service.run()
    finally:
        # The params store's write-behind thread is a daemon: a save
        # still pending would die with the process.
        ctx.params.flush()


if __name__ == "__main__":
    main()
