"""Platform enums and constants.

The port's copy of ``rafiki_tpu/constants.py``: the same strings, so
rows written by either package's stores read the same, and the same
``EnvVars`` names, so a service's environment reads the same to either
package's ``container/services.py``.
"""


class BudgetOption:
    MODEL_TRIAL_COUNT = "MODEL_TRIAL_COUNT"
    TIME_HOURS = "TIME_HOURS"
    CHIP_COUNT = "CHIP_COUNT"
    # Accepted alias for reference-script compatibility.
    GPU_COUNT = "GPU_COUNT"


DEFAULT_BUDGET = {
    BudgetOption.MODEL_TRIAL_COUNT: 5,
    BudgetOption.TIME_HOURS: 1.0,
    BudgetOption.CHIP_COUNT: 0,
}


class TrainJobStatus:
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"


class TrialStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    ERRORED = "ERRORED"
    TERMINATED = "TERMINATED"


class TaskType:
    IMAGE_CLASSIFICATION = "IMAGE_CLASSIFICATION"
    POS_TAGGING = "POS_TAGGING"
    LANGUAGE_MODELING = "LANGUAGE_MODELING"
    TABULAR_CLASSIFICATION = "TABULAR_CLASSIFICATION"
    TABULAR_REGRESSION = "TABULAR_REGRESSION"


class ParamsType:
    """Which shared parameters a trial proposal asks to warm-start
    from."""

    NONE = "NONE"
    LOCAL_RECENT = "LOCAL_RECENT"
    LOCAL_BEST = "LOCAL_BEST"
    GLOBAL_RECENT = "GLOBAL_RECENT"
    GLOBAL_BEST = "GLOBAL_BEST"


class ServiceType:
    TRAIN = "TRAIN"
    INFERENCE = "INFERENCE"
    PREDICT = "PREDICT"
    ADVISOR = "ADVISOR"


class UserType:
    SUPERADMIN = "SUPERADMIN"
    ADMIN = "ADMIN"
    MODEL_DEVELOPER = "MODEL_DEVELOPER"
    APP_DEVELOPER = "APP_DEVELOPER"


class InferenceJobStatus:
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"


class ServiceStatus:
    STARTED = "STARTED"
    DEPLOYING = "DEPLOYING"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"


class ModelAccessRight:
    PUBLIC = "PUBLIC"
    PRIVATE = "PRIVATE"


class EnvVars:
    """The environment a ``ServicesManager`` gives each service it
    launches, which ``container.build_service`` reads. The names are the
    reference's. ``CHIPS`` is the service's chip group: comma-separated
    CUDA device indices (the counterpart of ``CUDA_VISIBLE_DEVICES``).
    ``META_URI``, ``PARAMS_DIR`` and ``BUS_URI`` are the stores and the
    bus a service in a process of its own opens; ``LOG_DIR`` the shared
    log directory; ``NODE_ID`` the node that placed it.
    ``METRICS_ADDR`` is set by a service process itself, to the address
    its metrics server bound. ``PLATFORM`` is the device type a service
    process runs on (``torchenv.PLATFORM_ENV``)."""

    SERVICE_ID = "RAFIKI_TPU_SERVICE_ID"
    SERVICE_TYPE = "RAFIKI_TPU_SERVICE_TYPE"
    SUB_TRAIN_JOB_ID = "RAFIKI_TPU_SUB_TRAIN_JOB_ID"
    INFERENCE_JOB_ID = "RAFIKI_TPU_INFERENCE_JOB_ID"
    TRIAL_ID = "RAFIKI_TPU_TRIAL_ID"
    CHIPS = "RAFIKI_TPU_CHIPS"
    WORKDIR = "RAFIKI_TPU_WORKDIR"
    META_URI = "RAFIKI_TPU_META_URI"
    BUS_URI = "RAFIKI_TPU_BUS_URI"
    PARAMS_DIR = "RAFIKI_TPU_PARAMS_DIR"
    LOG_DIR = "RAFIKI_TPU_LOG_DIR"
    METRICS_ADDR = "RAFIKI_TPU_METRICS_ADDR"
    NODE_ID = "RAFIKI_TPU_NODE_ID"
    PLATFORM = "RAFIKI_TPU_PLATFORM"
