"""Typed node configuration: one validated object per node process.

The port's copy of ``NodeConfig`` from ``rafiki_tpu/config.py`` (:27,
:49-70, :369-700), with the fields whose consumers the port has. Each
field ``x`` is read from ``RAFIKI_TPU_<X>``; precedence is an explicit
override (the CLI's arguments), then the environment, then the
default. ``apply_env()`` writes the tunables back into ``os.environ``,
which is how the services built later in the process, and the service
processes it spawns, read them at construction.

Fields:

- the node's own: ``workdir``, ``port``, ``n_chips``, ``bus_uri``,
  ``supervise_interval``, ``log_level``, ``trace_dir`` (per-trial
  device traces), and ``coordinator``, ``num_processes`` and
  ``process_id``, which the ``serve`` CLI parses and refuses for now
  (multi-GPU, ROADMAP queue 1 item 8);
- placement and leases: ``chip_share`` (the time-sliced tier for a
  job's first worker; the reference reads ``RAFIKI_TPU_CHIP_SHARE``
  without a field), ``max_chip_share``, ``node_lease`` and
  ``worker_reregister``;
- the TCP bus client's ``bus_retry_base_s`` and ``bus_retry_total_s``,
  and ``metrics_port``, a service process's metrics-only server;
- the serving front's: the micro-batcher's (``serving_microbatch``,
  the fill window and its bounds, ``serving_max_batch``,
  ``serving_max_inflight``, ``serving_queue_cap``), replica sharding
  (``serving_shard_replicas``), per-client fairness
  (``serving_client_header``, ``serving_client_share``), the three
  serving switches the port's workers read (``serving_quant``,
  ``serving_stacked``, ``serving_generate``), the edge cache
  (``serving_cache_bytes``, ``serving_cache_ttl_s``,
  ``serving_cache_admit_after``), confidence tiering
  (``serving_tier_threshold``), the pipelined worker's auto threshold
  (``pipeline_sync_min``), the attribution ledger
  (``serving_attribution``) and the workload recorder
  (``workload_record``, ``workload_max_mb``,
  ``workload_retain_segments``).

Left out until their modules come (ROADMAP, queue 1): ``probe_timeout``
(the port does not probe the card; without one it raises), the
autoscaler's, the SLO plane's and the cluster fabric's fields, the
fault plan, and ``checkpoint_trials``.
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
    """Everything a ``python -m rafiki_torch serve`` node needs. Env var
    for field ``x``: ``RAFIKI_TPU_<X>``."""

    # --- The node ---
    workdir: str = "./rafiki_workdir"
    port: int = 3000
    n_chips: Optional[int] = None          # None = every CUDA device
    bus_uri: str = ""                      # "" = in-process bus
    supervise_interval: float = 10.0       # 0 turns the sweep off
    log_level: str = "info"
    trace_dir: str = ""                    # per-trial device traces

    # --- Multi-process membership (parsed; refused by serve for now) ---
    coordinator: str = ""
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    # --- Placement and leases ---
    # A job's first worker may time-share a chip others own when no
    # exclusive one is free (thread services only); off = never.
    chip_share: bool = True
    # Owners a chip may have in that time-sliced tier.
    max_chip_share: int = 4
    # An inference worker re-asserts its bus registration this often,
    # so a restarted broker learns it again.
    worker_reregister: float = 5.0
    # How long another node's RUNNING row stays credible without a
    # heartbeat, seconds.
    node_lease: float = 120.0

    # --- The TCP bus client's reconnection ---
    bus_retry_base_s: float = 0.05
    bus_retry_total_s: float = 15.0

    # A service process's metrics-only HTTP server; 0 = none.
    metrics_port: int = 0

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
        if not (0 <= self.port <= 65535):
            raise ValueError(f"port {self.port} out of range")
        if self.n_chips is not None and self.n_chips <= 0:
            raise ValueError("n_chips must be positive (or unset)")
        if self.supervise_interval < 0:
            raise ValueError("supervise_interval must be >= 0")
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
        if self.worker_reregister <= 0:
            raise ValueError("worker_reregister must be positive")
        if self.node_lease <= 0:
            raise ValueError("node_lease must be positive (it bounds "
                             "foreign-node liveness detection)")
        if self.max_chip_share < 1:
            raise ValueError("max_chip_share must be >= 1 (1 = no "
                             "time-sliced co-ownership)")
        if self.bus_retry_base_s <= 0:
            raise ValueError("bus_retry_base_s must be positive")
        if self.bus_retry_total_s < 0:
            raise ValueError("bus_retry_total_s must be >= 0 "
                             "(0 disables the retry budget)")
        if not (0 <= self.metrics_port <= 65535):
            raise ValueError(f"metrics_port {self.metrics_port} out of "
                             f"range (0 = no standalone server)")
        if self.log_level.upper() not in (
                "DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"):
            raise ValueError(f"unknown log_level {self.log_level!r}")
        multi = [self.coordinator != "", self.num_processes is not None,
                 self.process_id is not None]
        if any(multi) and not all(multi):
            raise ValueError("coordinator, num_processes and process_id "
                             "must be given together")
        if self.bus_uri and not (self.bus_uri.startswith("tcp://")
                                 or self.bus_uri.startswith("memory://")):
            raise ValueError(f"unsupported bus_uri {self.bus_uri!r}")
        return self

    def apply_env(self) -> None:
        """Export the tunables, so the services built later in this
        process, and the service processes it spawns, resolve the values
        this config validated."""
        if self.trace_dir:
            os.environ[self.env_name("trace_dir")] = self.trace_dir
        os.environ[self.env_name("chip_share")] = \
            "1" if self.chip_share else "0"
        for f in ("max_chip_share", "worker_reregister", "node_lease",
                  "bus_retry_base_s", "bus_retry_total_s"):
            os.environ[self.env_name(f)] = str(getattr(self, f))
        # 0 = no metrics server: an exported "0" would make a service
        # process bind a random port, so the variable goes instead.
        if self.metrics_port:
            os.environ[self.env_name("metrics_port")] = \
                str(self.metrics_port)
        else:
            os.environ.pop(self.env_name("metrics_port"), None)
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
