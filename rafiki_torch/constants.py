"""Platform enums and constants of the AutoML loop.

The port's copy of ``BudgetOption``, ``DEFAULT_BUDGET``,
``TrainJobStatus``, ``TrialStatus``, ``TaskType`` and ``ParamsType``
from ``rafiki_tpu/constants.py``: the same strings, so rows written by
either package's stores read the same.
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
