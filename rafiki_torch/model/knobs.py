"""Typed hyperparameter ("knob") declarations the Advisor searches over.

Parity: SURVEY.md §2 "Model SDK — knobs" (upstream ``rafiki/model/knob.py``):
``BaseKnob``, ``IntegerKnob``, ``FloatKnob``, ``CategoricalKnob``,
``FixedKnob``, plus the architecture/policy knobs ENAS-era models use.

Design notes (TPU-first additions, not in the reference):

- Every knob knows how to ``sample`` itself from a ``numpy.random.Generator``
  (powers the random advisor) and how to map to/from a point in a
  fixed-dimension continuous box (``vector_dim`` / ``to_vector`` /
  ``from_vector``), which powers the Bayesian GP advisor without
  advisor-side special-casing.
- Knob configs serialise to plain JSON so they can cross the Admin REST
  boundary and be stored in the meta store.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np

KnobConfig = Dict[str, "BaseKnob"]
Knobs = Dict[str, Any]


class BaseKnob:
    """A single tunable hyperparameter declaration."""

    def validate(self, value: Any) -> Any:
        """Return a normalised value or raise ``ValueError``."""
        raise NotImplementedError

    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError

    # --- Continuous-box embedding (for GP/Bayesian advisors) ---

    @property
    def vector_dim(self) -> int:
        """Number of [0,1] dimensions this knob occupies; 0 = not searchable."""
        return 0

    def to_vector(self, value: Any) -> List[float]:
        return []

    def from_vector(self, x: Sequence[float]) -> Any:
        raise NotImplementedError

    # --- JSON serde ---

    def to_json(self) -> Dict[str, Any]:
        raise NotImplementedError

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "BaseKnob":
        kind = d["kind"]
        cls = _KNOB_KINDS.get(kind)
        if cls is None:
            raise ValueError(f"Unknown knob kind: {kind}")
        return cls._from_json(d)


class FixedKnob(BaseKnob):
    """A knob pinned to a constant value (not searched)."""

    def __init__(self, value: Any):
        self.value = value

    def validate(self, value):
        if value != self.value:
            raise ValueError(f"FixedKnob expects {self.value!r}, got {value!r}")
        return value

    def sample(self, rng):
        return self.value

    def to_json(self):
        return {"kind": "fixed", "value": self.value}

    @classmethod
    def _from_json(cls, d):
        return cls(d["value"])

    def __repr__(self):
        return f"FixedKnob({self.value!r})"


class CategoricalKnob(BaseKnob):
    """A choice among a finite list of JSON-serialisable values."""

    def __init__(self, values: Sequence[Any]):
        if len(values) == 0:
            raise ValueError("CategoricalKnob needs at least one value")
        self.values = list(values)

    def validate(self, value):
        if value not in self.values:
            raise ValueError(f"{value!r} not in {self.values!r}")
        return value

    def sample(self, rng):
        return self.values[int(rng.integers(len(self.values)))]

    @property
    def vector_dim(self):
        return len(self.values) if len(self.values) > 1 else 0

    def to_vector(self, value):
        if len(self.values) <= 1:
            return []
        v = [0.0] * len(self.values)
        v[self.values.index(value)] = 1.0
        return v

    def from_vector(self, x):
        if len(self.values) <= 1:
            return self.values[0]
        return self.values[int(np.argmax(np.asarray(x)))]

    def to_json(self):
        return {"kind": "categorical", "values": self.values}

    @classmethod
    def _from_json(cls, d):
        return cls(d["values"])

    def __repr__(self):
        return f"CategoricalKnob({self.values!r})"


class IntegerKnob(BaseKnob):
    """An integer in ``[value_min, value_max]``; ``is_exp`` searches log-scale."""

    def __init__(self, value_min: int, value_max: int, is_exp: bool = False):
        if value_min > value_max:
            raise ValueError("value_min > value_max")
        if is_exp and value_min <= 0:
            raise ValueError("is_exp requires value_min > 0")
        self.value_min = int(value_min)
        self.value_max = int(value_max)
        self.is_exp = is_exp

    def validate(self, value):
        value = int(value)
        if not (self.value_min <= value <= self.value_max):
            raise ValueError(
                f"{value} outside [{self.value_min}, {self.value_max}]")
        return value

    def sample(self, rng):
        if self.is_exp:
            lo, hi = math.log(self.value_min), math.log(self.value_max)
            return self.validate(round(math.exp(rng.uniform(lo, hi))))
        return int(rng.integers(self.value_min, self.value_max + 1))

    @property
    def vector_dim(self):
        return 0 if self.value_min == self.value_max else 1

    def to_vector(self, value):
        if self.vector_dim == 0:
            return []
        if self.is_exp:
            lo, hi = math.log(self.value_min), math.log(self.value_max)
            return [(math.log(value) - lo) / (hi - lo)]
        return [(value - self.value_min) / (self.value_max - self.value_min)]

    def from_vector(self, x):
        if self.vector_dim == 0:
            return self.value_min
        t = float(np.clip(x[0], 0.0, 1.0))
        if self.is_exp:
            lo, hi = math.log(self.value_min), math.log(self.value_max)
            return self.validate(round(math.exp(lo + t * (hi - lo))))
        return self.validate(round(self.value_min + t * (self.value_max - self.value_min)))

    def to_json(self):
        return {"kind": "integer", "value_min": self.value_min,
                "value_max": self.value_max, "is_exp": self.is_exp}

    @classmethod
    def _from_json(cls, d):
        return cls(d["value_min"], d["value_max"], d.get("is_exp", False))

    def __repr__(self):
        return f"IntegerKnob({self.value_min}, {self.value_max}, is_exp={self.is_exp})"


class FloatKnob(BaseKnob):
    """A float in ``[value_min, value_max]``; ``is_exp`` searches log-scale."""

    def __init__(self, value_min: float, value_max: float, is_exp: bool = False):
        if value_min > value_max:
            raise ValueError("value_min > value_max")
        if is_exp and value_min <= 0:
            raise ValueError("is_exp requires value_min > 0")
        self.value_min = float(value_min)
        self.value_max = float(value_max)
        self.is_exp = is_exp

    def validate(self, value):
        value = float(value)
        if not (self.value_min <= value <= self.value_max):
            raise ValueError(
                f"{value} outside [{self.value_min}, {self.value_max}]")
        return value

    def _clip(self, value: float) -> float:
        # exp(log(x)) != x in float64, so log-scale round-trips can land
        # epsilon outside the box; clamp so validate() always passes.
        return min(max(value, self.value_min), self.value_max)

    def sample(self, rng):
        if self.is_exp:
            lo, hi = math.log(self.value_min), math.log(self.value_max)
            return self._clip(math.exp(rng.uniform(lo, hi)))
        return float(rng.uniform(self.value_min, self.value_max))

    @property
    def vector_dim(self):
        return 0 if self.value_min == self.value_max else 1

    def to_vector(self, value):
        if self.vector_dim == 0:
            return []
        if self.is_exp:
            lo, hi = math.log(self.value_min), math.log(self.value_max)
            return [(math.log(value) - lo) / (hi - lo)]
        return [(value - self.value_min) / (self.value_max - self.value_min)]

    def from_vector(self, x):
        if self.vector_dim == 0:
            return self.value_min
        t = float(np.clip(x[0], 0.0, 1.0))
        if self.is_exp:
            lo, hi = math.log(self.value_min), math.log(self.value_max)
            return self._clip(math.exp(lo + t * (hi - lo)))
        return self._clip(self.value_min + t * (self.value_max - self.value_min))

    def to_json(self):
        return {"kind": "float", "value_min": self.value_min,
                "value_max": self.value_max, "is_exp": self.is_exp}

    @classmethod
    def _from_json(cls, d):
        return cls(d["value_min"], d["value_max"], d.get("is_exp", False))

    def __repr__(self):
        return f"FloatKnob({self.value_min}, {self.value_max}, is_exp={self.is_exp})"


class ArchKnob(BaseKnob):
    """An architecture encoding: a list of positions, each a categorical choice.

    Used by the ENAS supernet: the value is a list of integers (one per
    position), e.g. ``[op_0, input_0, op_1, input_1, ...]``. The search over
    this knob is driven by the ENAS controller advisor, not the GP advisor,
    so it deliberately exposes ``vector_dim == 0``.

    Parity: SURVEY.md §2 (arch knobs for ENAS in later upstream versions).
    """

    def __init__(self, positions: Sequence[Sequence[int]]):
        # positions[i] = allowed values at position i
        if len(positions) == 0:
            raise ValueError("ArchKnob needs at least one position")
        self.positions = [list(p) for p in positions]

    def validate(self, value):
        value = [int(v) for v in value]
        if len(value) != len(self.positions):
            raise ValueError(
                f"arch length {len(value)} != {len(self.positions)}")
        for i, (v, allowed) in enumerate(zip(value, self.positions)):
            if v not in allowed:
                raise ValueError(f"position {i}: {v} not in {allowed}")
        return value

    def sample(self, rng):
        return [p[int(rng.integers(len(p)))] for p in self.positions]

    def to_json(self):
        return {"kind": "arch", "positions": self.positions}

    @classmethod
    def _from_json(cls, d):
        return cls(d["positions"])

    def __repr__(self):
        return f"ArchKnob(<{len(self.positions)} positions>)"


class PolicyKnob(BaseKnob):
    """Declares that the model implements a named training policy.

    The advisor/worker decides per-trial whether to activate the policy and
    passes True/False as the knob value. Known policies mirror the
    reference's ENAS-era set: ``SHARE_PARAMS``, ``EARLY_STOP``,
    ``SKIP_TRAIN``, ``QUICK_TRAIN``, ``QUICK_EVAL``, ``DOWNSCALE``.
    """

    def __init__(self, policy: str):
        self.policy = policy

    def validate(self, value):
        return bool(value)

    def sample(self, rng):
        return False

    def to_json(self):
        return {"kind": "policy", "policy": self.policy}

    @classmethod
    def _from_json(cls, d):
        return cls(d["policy"])

    def __repr__(self):
        return f"PolicyKnob({self.policy!r})"


_KNOB_KINDS = {
    "fixed": FixedKnob,
    "categorical": CategoricalKnob,
    "integer": IntegerKnob,
    "float": FloatKnob,
    "arch": ArchKnob,
    "policy": PolicyKnob,
}


# --- Knob-config level helpers ---

def validate_knobs(knob_config: KnobConfig, knobs: Knobs) -> Knobs:
    """Validate a full knob assignment against a config; returns normalised."""
    unknown = set(knobs) - set(knob_config)
    if unknown:
        raise ValueError(f"Unknown knobs: {sorted(unknown)}")
    out = {}
    for name, knob in knob_config.items():
        if name not in knobs:
            if isinstance(knob, FixedKnob):
                # Fixed (deployment) knobs default to their pinned
                # value, so trial rows recorded before a model gained a
                # new FixedKnob stay loadable.
                out[name] = knob.value
                continue
            raise ValueError(f"Missing knob: {name}")
        out[name] = knob.validate(knobs[name])
    return out


def sample_knobs(knob_config: KnobConfig, rng: np.random.Generator) -> Knobs:
    return {name: knob.sample(rng) for name, knob in knob_config.items()}


def knob_config_to_json(knob_config: KnobConfig) -> Dict[str, Any]:
    return {name: knob.to_json() for name, knob in knob_config.items()}


def knob_config_from_json(d: Dict[str, Any]) -> KnobConfig:
    return {name: BaseKnob.from_json(kd) for name, kd in d.items()}


def searchable_dims(knob_config: KnobConfig) -> int:
    """Total continuous-box dimensionality of the searchable knobs."""
    return sum(k.vector_dim for k in knob_config.values())


def knobs_to_vector(knob_config: KnobConfig, knobs: Knobs) -> np.ndarray:
    """Embed a knob assignment into the continuous box (GP advisor input)."""
    xs: List[float] = []
    for name in sorted(knob_config):
        xs.extend(knob_config[name].to_vector(knobs[name]))
    return np.asarray(xs, dtype=np.float64)


def vector_to_knobs(knob_config: KnobConfig, x: np.ndarray,
                    rng: np.random.Generator | None = None) -> Knobs:
    """Decode a continuous-box point back into a knob assignment.

    Knobs with ``vector_dim == 0`` (fixed, single-value, arch, policy) are
    filled with their sample/default value.
    """
    rng = rng or np.random.default_rng(0)
    knobs: Knobs = {}
    i = 0
    for name in sorted(knob_config):
        knob = knob_config[name]
        d = knob.vector_dim
        if d == 0:
            knobs[name] = knob.sample(rng)
        else:
            knobs[name] = knob.from_vector(np.asarray(x[i:i + d]))
            i += d
    return knobs
