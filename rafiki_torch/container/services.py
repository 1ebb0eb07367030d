"""Service entry points: a service's environment -> its worker object.

The port's copy of ``SystemContext``, ``build_service`` and
``_build_advisor_service`` from ``rafiki_tpu/container/services.py``
(:23-122). ``build_service`` reads ``EnvVars.SERVICE_TYPE`` and builds
the train worker, advisor service, inference worker or predictor
service, each bound to the chip group its environment names
(``EnvVars.CHIPS``) on the context's device type. The reference's
``main``, the process entry that binds jax, has no counterpart yet:
the port runs its services as threads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from ..bus import BaseBus
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


def build_service(env: Dict[str, str], ctx: SystemContext) -> Any:
    """Construct (not start) the worker object for a service env."""
    service_type = env[EnvVars.SERVICE_TYPE]
    service_id = env[EnvVars.SERVICE_ID]
    chips = (ChipGroup.from_env(env[EnvVars.CHIPS], ctx.device_type)
             if env.get(EnvVars.CHIPS) else None)
    if service_type == ServiceType.TRAIN:
        from ..worker.train import TrainWorker

        return TrainWorker(service_id, env[EnvVars.SUB_TRAIN_JOB_ID],
                           ctx.meta, ctx.params, ctx.bus, chips=chips)
    if service_type == ServiceType.ADVISOR:
        return _build_advisor_service(env[EnvVars.SUB_TRAIN_JOB_ID], ctx)
    if service_type == ServiceType.INFERENCE:
        from ..worker.inference import BusInferenceWorker

        return BusInferenceWorker(
            service_id, env[EnvVars.INFERENCE_JOB_ID],
            env[EnvVars.TRIAL_ID], ctx.meta, ctx.params, ctx.bus,
            chips=chips)
    if service_type == ServiceType.PREDICT:
        from ..predictor.app import PredictorService

        return PredictorService.for_job(service_id,
                                        env[EnvVars.INFERENCE_JOB_ID],
                                        ctx.meta, ctx.bus)
    raise ValueError(f"unknown service type: {service_type!r}")


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
