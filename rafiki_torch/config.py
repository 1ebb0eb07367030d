"""Typed node configuration: the serving knobs of one node, validated.

The port's copy of the serving part of ``NodeConfig`` from
``rafiki_tpu/config.py`` (:27, :369-447, :456-470, :641-653). Each
field ``x`` is read from ``RAFIKI_TPU_<X>``; precedence is an explicit
override, then the environment, then the default. ``apply_env()``
writes the serving tunables back into ``os.environ``, which is how the
services built later in the process (the predictor, the inference
workers) read them at construction.

Fields: the micro-batcher's (``serving_microbatch``, the fill window
and its bounds, ``serving_max_batch``, ``serving_max_inflight``,
``serving_queue_cap``), replica sharding (``serving_shard_replicas``),
per-client fairness (``serving_client_header``,
``serving_client_share``), the three serving switches the port's
workers read (``serving_quant``, ``serving_stacked``,
``serving_generate``), the edge cache (``serving_cache_bytes``,
``serving_cache_ttl_s``, ``serving_cache_admit_after``), confidence
tiering (``serving_tier_threshold``), the pipelined worker's auto
threshold (``pipeline_sync_min``), the attribution ledger
(``serving_attribution``) and the workload recorder
(``workload_record``, ``workload_max_mb``,
``workload_retain_segments``). The reference's cluster, autoscale,
node lease, SLO and trace fields are not here yet.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Union

from .observe.wire import QUANT_MODES, QUANT_OFF_SPELLINGS, \
    STACKED_SPELLINGS, stacked_mode

_PREFIX = "RAFIKI_TPU_"


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


def parse_tristate_bool(raw: str) -> Optional[bool]:
    """The tri-state spelling ("auto" -> None, a falsy spelling ->
    False, anything else -> True) that the inference worker reads
    ``RAFIKI_TPU_SERVING_PIPELINE`` with."""
    if raw.strip().lower() == "auto":
        return None
    return _parse_bool(raw)


@dataclass(frozen=True)
class NodeConfig:
    """The serving tunables of a node. Env var for field ``x``:
    ``RAFIKI_TPU_<X>``."""

    # --- Serving frontend: continuous cross-request micro-batching ---
    serving_microbatch: bool = True        # off = one scatter a request
    serving_fill_window: float = 0.005     # the adaptive window's
    #                                        ceiling by default
    serving_fill_window_min: float = 0.0   # adaptive floor; == max pins
    serving_fill_window_max: Optional[float] = None  # None = use
    #                                        serving_fill_window
    serving_max_batch: int = 1024          # queries a super-batch
    serving_max_inflight: int = 2          # scattered, ungathered batches
    serving_queue_cap: int = 4096          # admission bound (queries);
    #                                        beyond it: 429 + Retry-After
    # Each trial bin's slice of a super-batch is split over all its
    # live replicas, weighted by their latency.
    serving_shard_replicas: bool = True
    # Per-client fairness: the header that names a client ("" = off)
    # and the share of the admission queue one client may hold.
    serving_client_header: str = ""
    serving_client_share: float = 0.25
    # The inference workers' switches (``observe/wire.py``): int8
    # weights ("" = the trained dtype), stacked bins, generation.
    serving_quant: str = ""
    serving_stacked: str = "on"
    serving_generate: bool = False
    # The predictor's edge cache: a byte budget (0 = off, no cache
    # series), the age of an answer, and the miss that admits a key
    # (2 = second touch).
    serving_cache_bytes: int = 0
    serving_cache_ttl_s: float = 60.0
    serving_cache_admit_after: int = 2
    # Confidence tiering: queries whose best-bin softmax margin clears
    # this are answered by the best bin alone (0 = off, no tier series).
    serving_tier_threshold: float = 0.0
    # With RAFIKI_TPU_SERVING_PIPELINE=auto an inference worker keeps
    # one burst in flight when its measured sync round trip (seconds)
    # is at least this.
    pipeline_sync_min: float = 0.02
    # Per-bin and per-tenant request and device-time accounting (off =
    # zero serving_bin_* / serving_tenant_* series).
    serving_attribution: bool = False
    # One JSONL arrival record a request at the predictor edge, in
    # segments of workload_max_mb, keeping workload_retain_segments
    # rolled ones.
    workload_record: bool = False
    workload_max_mb: float = 64.0
    workload_retain_segments: int = 4

    _types_cache = None  # deliberately un-annotated: not a field

    @classmethod
    def env_name(cls, field: str) -> str:
        return _PREFIX + field.upper()

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None,
                 **overrides: Any) -> "NodeConfig":
        """Build from env vars; ``overrides`` win. An override of
        ``None`` means "not given" and is dropped."""
        env = os.environ if env is None else env
        values: Dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            raw = env.get(cls.env_name(f.name))
            if raw is None:
                continue
            values[f.name] = cls._coerce(f.name, raw)
        values.update({k: v for k, v in overrides.items()
                       if v is not None})
        cfg = cls(**values)
        cfg.validate()
        return cfg

    @classmethod
    def _coerce(cls, name: str, raw: str) -> Any:
        target = cls._field_types().get(name, str)
        try:
            if target is bool:
                if raw.strip().lower() == "auto":
                    raise ValueError("'auto' is only valid for "
                                     "tri-state fields")
                return _parse_bool(raw)
            if target is int:
                return int(raw)
            if target is float:
                return float(raw)
        except ValueError as e:
            raise ValueError(
                f"{cls.env_name(name)}={raw!r}: {e}") from None
        return raw

    @classmethod
    def _field_types(cls) -> Dict[str, type]:
        """The scalar type of each field, ``Optional`` unwrapped."""
        if cls._types_cache is None:
            resolved: Dict[str, type] = {}
            hints = typing.get_type_hints(cls)
            for f in dataclasses.fields(cls):
                hint = hints.get(f.name, str)
                if typing.get_origin(hint) is Union:
                    args = [a for a in typing.get_args(hint)
                            if a is not type(None)]
                    hint = args[0] if len(args) == 1 else str
                resolved[f.name] = hint if isinstance(hint, type) else str
            cls._types_cache = resolved
        return cls._types_cache

    def validate(self) -> "NodeConfig":
        if self.serving_fill_window < 0:
            raise ValueError("serving_fill_window must be >= 0")
        if self.serving_max_batch < 1 or self.serving_max_inflight < 1 \
                or self.serving_queue_cap < 1:
            raise ValueError("serving_max_batch, serving_max_inflight "
                             "and serving_queue_cap must be >= 1")
        fw_max = (self.serving_fill_window
                  if self.serving_fill_window_max is None
                  else self.serving_fill_window_max)
        if not (0 <= self.serving_fill_window_min <= fw_max):
            raise ValueError("need 0 <= serving_fill_window_min <= "
                             "serving_fill_window_max")
        if not (0.0 <= self.serving_client_share <= 1.0):
            raise ValueError("serving_client_share must be within "
                             "[0, 1]")
        if self.serving_cache_bytes < 0:
            raise ValueError("serving_cache_bytes must be >= 0 "
                             "(0 disables the edge cache)")
        if self.serving_cache_ttl_s <= 0:
            raise ValueError("serving_cache_ttl_s must be positive")
        if self.serving_cache_admit_after < 1:
            raise ValueError("serving_cache_admit_after must be >= 1 "
                             "(1 = admit on first touch)")
        if self.serving_tier_threshold < 0:
            raise ValueError("serving_tier_threshold must be >= 0 "
                             "(0 disables tiered serving)")
        if self.pipeline_sync_min < 0:
            raise ValueError("pipeline_sync_min must be >= 0 (0 = "
                             "auto-pipeline whenever any sync latency "
                             "is measured)")
        if self.workload_max_mb <= 0:
            raise ValueError("workload_max_mb must be positive")
        if self.workload_retain_segments < 1:
            raise ValueError("workload_retain_segments must be >= 1")
        if self.serving_quant.strip().lower() not in \
                QUANT_OFF_SPELLINGS + QUANT_MODES:
            raise ValueError(
                f"serving_quant {self.serving_quant!r} is not one of "
                f"''/int8")
        if self.serving_stacked.strip().lower() not in STACKED_SPELLINGS:
            raise ValueError(
                f"serving_stacked {self.serving_stacked!r} is not one "
                f"of on/off")
        return self

    def apply_env(self) -> None:
        """Export the serving tunables, so the services built later in
        this process resolve the values this config validated."""
        os.environ[self.env_name("serving_microbatch")] = \
            "1" if self.serving_microbatch else "0"
        os.environ[self.env_name("serving_shard_replicas")] = \
            "1" if self.serving_shard_replicas else "0"
        for f in ("serving_fill_window", "serving_fill_window_min",
                  "serving_max_batch", "serving_max_inflight",
                  "serving_queue_cap", "serving_client_share",
                  "serving_cache_bytes", "serving_cache_ttl_s",
                  "serving_cache_admit_after", "serving_tier_threshold",
                  "pipeline_sync_min", "workload_max_mb",
                  "workload_retain_segments"):
            os.environ[self.env_name(f)] = str(getattr(self, f))
        for f in ("serving_attribution", "workload_record"):
            if getattr(self, f):
                os.environ[self.env_name(f)] = "1"
            else:
                os.environ.pop(self.env_name(f), None)
        if self.serving_generate:
            os.environ[self.env_name("serving_generate")] = "1"
        else:
            os.environ.pop(self.env_name("serving_generate"), None)
        if self.serving_quant.strip():
            os.environ[self.env_name("serving_quant")] = \
                self.serving_quant
        else:
            os.environ.pop(self.env_name("serving_quant"), None)
        os.environ[self.env_name("serving_stacked")] = \
            "on" if stacked_mode(self.serving_stacked) else "off"
        # The adaptive ceiling defaults to the fixed knob; only an
        # explicit one is exported.
        if self.serving_fill_window_max is not None:
            os.environ[self.env_name("serving_fill_window_max")] = \
                str(self.serving_fill_window_max)
        else:
            os.environ.pop(self.env_name("serving_fill_window_max"),
                           None)
        if self.serving_client_header:
            os.environ[self.env_name("serving_client_header")] = \
                self.serving_client_header
        else:
            os.environ.pop(self.env_name("serving_client_header"), None)
