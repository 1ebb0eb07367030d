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
  ``process_id``, which make ``serve`` one process of a node over
  several (``parallel.dist.initialize``, before the platform is built);
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
  (``serving_client_header``, ``serving_client_share``), the serving
  switches (``serving_packed_wire``, which the cache, the predictor and
  the inference worker read, and ``serving_quant``,
  ``serving_stacked`` and ``serving_generate``, which the workers
  read), the edge cache
  (``serving_cache_bytes``, ``serving_cache_ttl_s``,
  ``serving_cache_admit_after``), confidence tiering
  (``serving_tier_threshold``), the pipelined worker's auto threshold
  (``pipeline_sync_min``), the attribution ledger
  (``serving_attribution``) and the workload recorder
  (``workload_record``, ``workload_max_mb``,
  ``workload_retain_segments``);
- the inference worker's ``serving_pipeline`` (tri-state: ``auto``, the
  default, is None) and the generation engine's ``generate_page_size``,
  ``generate_pool_pages``, ``generate_decode_batch`` and
  ``generate_max_new``;
- observability: ``metrics``, ``metrics_exemplars``, ``trace_sample``,
  ``trace_max_mb``, ``trace_retain_segments``, ``trace_retain_mb``,
  ``trace_tail_sample`` and ``trace_tail_slow_ms``;
- the fault plane's ``fault_plan`` (parsed by ``validate``, so a typo
  fails the node's construction) and ``fault_seed`` (``faults.py``);
- the cluster fabric's ``cluster_fabric`` (off by default: no node
  registry, no frontend registry, no relay routing, no new series or
  thread), ``cluster_probe_timeout_s`` and ``cluster_locality_boost``;
- the serving control loop's: the autoscaler's ``autoscale`` (off by
  default) and its ``autoscale_*`` policy knobs, whose
  ``autoscale_periodicity`` table ``validate`` loads, and the SLO
  plane's ``slo_rules`` (parsed by ``validate``; "" = off),
  ``slo_webhook_url`` and ``slo_alert_log_mb``.

- the trial loop's: ``checkpoint_trials`` (``RAFIKI_TPU_CKPT``, the
  runner's crash-resume checkpoints, off by default),
  ``advisor_prefetch`` (the train worker's ``PrefetchAdvisor``, on by
  default), ``params_write_behind`` (the ``ParamStore``'s writer thread,
  on by default, read a save) and the residency caches' ``dataset_cache_bytes`` (the host
  dataset cache), ``stage_cache_bytes`` (the device staging cache) and
  ``stage_bytes`` (the largest set staged whole), each read per call
  by its cache.

Left out until its module comes (ROADMAP, queue 1): ``probe_timeout``
(the port does not probe the card; without one it raises).
"""

from __future__ import annotations

import dataclasses
import os
import typing
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Union

from .observe.wire import (known_packed_wire_spelling,
                           known_quant_spelling, known_stacked_spelling,
                           packed_wire_mode, stacked_mode)

_PREFIX = "RAFIKI_TPU_"


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


def cluster_fabric_enabled() -> bool:
    """The cluster fabric's gate, ``RAFIKI_TPU_CLUSTER_FABRIC`` (off by
    default), read by each part when it is built."""
    return _parse_bool(os.environ.get(_PREFIX + "CLUSTER_FABRIC", "0"))


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
    # The packed batch wire (``observe/wire.py``): "on" packs a shard
    # toward a worker that advertises it, "compat" sends per-query
    # frames but keeps the wire series, "off" per-query frames and no
    # wire series.
    serving_packed_wire: str = "on"
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
    # One burst in flight on an inference worker: None = auto (measure
    # the sync round trip, pipeline_sync_min above).
    serving_pipeline: Optional[bool] = None

    # --- Generation engine (RAFIKI_TPU_SERVING_GENERATE workers) ---
    generate_page_size: int = 16           # tokens a KV page
    generate_pool_pages: int = 256         # pages; page 0 is scratch
    generate_decode_batch: int = 8         # lanes a decode step
    generate_max_new: int = 128            # tokens a request, at most

    # --- The autoscaler (admin/autoscaler.py) ---
    # Off: supervise pays one attribute check and no autoscale series
    # exists.
    autoscale: bool = False
    autoscale_dry_run: bool = False        # record, do not actuate
    autoscale_max_replicas: int = 4        # a bin's ceiling
    autoscale_step: int = 1                # replicas added a sweep
    autoscale_up_cooldown_s: float = 10.0
    autoscale_down_cooldown_s: float = 60.0
    # The hysteresis band over queue_depth/queue_cap.
    autoscale_queue_high: float = 0.25
    autoscale_queue_low: float = 0.02
    autoscale_p99_high_ms: float = 0.0     # 0 = p99 not consulted
    # Idle-train preemption: a sub-job under this MFU for idle_sweeps
    # sweeps gives a worker to a starved bin (0 = never).
    autoscale_mfu_floor: float = 0.05
    autoscale_idle_sweeps: int = 3
    # Predictive scale-ahead (0 = off) and its learned periodicity
    # table ("" = the queue trend only).
    autoscale_predict_horizon_s: float = 0.0
    autoscale_periodicity: str = ""
    autoscale_predict_ramp_ratio: float = 1.5

    # --- The SLO plane (observe/slo.py, admin/slo_engine.py) ---
    # A rules file (.json/.toml) or the inline grammar; "" = off, no
    # slo series.
    slo_rules: str = ""
    slo_webhook_url: str = ""              # "" = no webhook thread
    slo_alert_log_mb: float = 16.0         # alerts.jsonl's roll size

    # --- Robustness: the fault plane (faults.py) ---
    # ";"-separated site.kind:params rules; "" = disarmed.
    fault_plan: str = ""
    # The PRNG seed of p= rules: a seeded plan replays its decisions.
    fault_seed: int = 0

    # --- The cluster serving fabric ---
    # Off: no node registry, frontend registry, peer probes, gossip or
    # relay routing, and no new series or thread.
    cluster_fabric: bool = False
    # The bound on one peer-cache probe, seconds.
    cluster_probe_timeout_s: float = 0.25
    # A same-node replica's shard weight is multiplied by this.
    cluster_locality_boost: float = 1.0

    # --- The trial loop ---
    # Mid-trial epoch checkpoints a re-proposed trial resumes after a
    # worker died (RAFIKI_TPU_CKPT).
    checkpoint_trials: bool = False
    # Train workers compute the next proposal while a trial trains.
    advisor_prefetch: bool = True
    # ParamStore write-behind: save() returns before the file is on disk
    # (store/params.py). Off = synchronous saves.
    params_write_behind: bool = True
    # The host dataset cache: parsed sets stay resident across trials,
    # keyed by (path, mtime, size), a byte-budget LRU. 0 disables it.
    dataset_cache_bytes: int = 1 << 30
    # The device staging cache: a set's uint8 images and int32 labels
    # stay on the card across trials. 0 disables it.
    stage_cache_bytes: int = 2 << 30
    # Sets of up to this many image bytes are staged whole on the card
    # (one copy, batches gathered by index); larger ones a chunk at a
    # time.
    stage_bytes: int = 2 << 30

    # --- Observability ---
    metrics: bool = True                   # /metrics and the series
    trace_sample: float = 1.0              # fresh traces sampled, 0..1
    trace_max_mb: float = 64.0             # a span segment's size cap
    trace_retain_segments: int = 4         # rolled segments kept
    trace_retain_mb: float = 256.0         # their byte budget
    # Tail sampling: fast, ok traces kept at this rate (1.0 = off);
    # errors and those slower than trace_tail_slow_ms always.
    trace_tail_sample: float = 1.0
    trace_tail_slow_ms: float = 250.0
    metrics_exemplars: bool = False

    # Fields whose variables are not RAFIKI_TPU_<FIELD> (the
    # reference's names). Un-annotated, so none of these is a field.
    _ENV_MAP = {"checkpoint_trials": "RAFIKI_TPU_CKPT"}
    _types_cache = None
    _tristate_cache = None

    @classmethod
    def env_name(cls, field: str) -> str:
        return cls._ENV_MAP.get(field, _PREFIX + field.upper())

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
                if name in cls._tristate_bools():
                    return parse_tristate_bool(raw)
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
        """The scalar type of each field, ``Optional`` unwrapped; an
        ``Optional[bool]`` field is tri-state (``auto`` is None)."""
        if cls._types_cache is None:
            resolved: Dict[str, type] = {}
            tristate = set()
            hints = typing.get_type_hints(cls)
            for f in dataclasses.fields(cls):
                hint = hints.get(f.name, str)
                if typing.get_origin(hint) is Union:
                    args = [a for a in typing.get_args(hint)
                            if a is not type(None)]
                    hint = args[0] if len(args) == 1 else str
                    if hint is bool:
                        tristate.add(f.name)
                resolved[f.name] = hint if isinstance(hint, type) else str
            cls._tristate_cache = tristate
            cls._types_cache = resolved
        return cls._types_cache

    @classmethod
    def _tristate_bools(cls) -> set:
        cls._field_types()
        return cls._tristate_cache

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
        if not known_packed_wire_spelling(self.serving_packed_wire):
            raise ValueError(
                f"serving_packed_wire {self.serving_packed_wire!r} is "
                f"not one of on/off/compat")
        if not known_quant_spelling(self.serving_quant):
            raise ValueError(
                f"serving_quant {self.serving_quant!r} is not one of "
                f"''/int8")
        if not known_stacked_spelling(self.serving_stacked):
            raise ValueError(
                f"serving_stacked {self.serving_stacked!r} is not one "
                f"of on/off")
        if self.generate_page_size < 1:
            raise ValueError("generate_page_size must be >= 1")
        if self.generate_pool_pages < 2:
            raise ValueError("generate_pool_pages must be >= 2 "
                             "(page 0 is reserved scratch)")
        if self.generate_decode_batch < 1:
            raise ValueError("generate_decode_batch must be >= 1")
        if self.generate_max_new < 1:
            raise ValueError("generate_max_new must be >= 1")
        if self.worker_reregister <= 0:
            raise ValueError("worker_reregister must be positive")
        if self.node_lease <= 0:
            raise ValueError("node_lease must be positive (it bounds "
                             "foreign-node liveness detection)")
        if self.autoscale_max_replicas < 1 or self.autoscale_step < 1:
            raise ValueError("autoscale_max_replicas and autoscale_step "
                             "must be >= 1")
        if self.autoscale_up_cooldown_s < 0 \
                or self.autoscale_down_cooldown_s < 0:
            raise ValueError("autoscale cooldowns must be >= 0")
        if not (0.0 <= self.autoscale_queue_low
                <= self.autoscale_queue_high <= 1.0):
            raise ValueError("need 0 <= autoscale_queue_low <= "
                             "autoscale_queue_high <= 1")
        if self.autoscale_p99_high_ms < 0:
            raise ValueError("autoscale_p99_high_ms must be >= 0 "
                             "(0 = p99 not consulted)")
        if self.autoscale_mfu_floor < 0:
            raise ValueError("autoscale_mfu_floor must be >= 0 "
                             "(0 disables preemption)")
        if self.autoscale_idle_sweeps < 1:
            raise ValueError("autoscale_idle_sweeps must be >= 1")
        if self.autoscale_predict_horizon_s < 0:
            raise ValueError("autoscale_predict_horizon_s must be >= 0 "
                             "(0 disables predictive scale-ahead)")
        if self.autoscale_predict_ramp_ratio < 1.0:
            raise ValueError("autoscale_predict_ramp_ratio must be "
                             ">= 1 (a recurring ramp must mean MORE "
                             "load, not less)")
        if self.autoscale_periodicity.strip():
            # A missing or malformed table fails the node's construction.
            from .admin.capacity import load_periodicity

            load_periodicity(self.autoscale_periodicity)
        if self.max_chip_share < 1:
            raise ValueError("max_chip_share must be >= 1 (1 = no "
                             "time-sliced co-ownership)")
        if self.dataset_cache_bytes < 0 or self.stage_cache_bytes < 0:
            raise ValueError("dataset_cache_bytes and stage_cache_bytes "
                             "must be >= 0 (0 disables the cache)")
        if self.stage_bytes < 0:
            raise ValueError("stage_bytes must be >= 0 (0 forces "
                             "per-chunk staging)")
        if self.bus_retry_base_s <= 0:
            raise ValueError("bus_retry_base_s must be positive")
        if self.bus_retry_total_s < 0:
            raise ValueError("bus_retry_total_s must be >= 0 "
                             "(0 disables the retry budget)")
        if self.cluster_probe_timeout_s <= 0:
            raise ValueError("cluster_probe_timeout_s must be positive "
                             "(it bounds the single peer-cache probe)")
        if self.cluster_locality_boost < 1.0:
            raise ValueError("cluster_locality_boost must be >= 1 "
                             "(1.0 = no locality preference; below 1 "
                             "would PENALIZE same-node replicas)")
        if self.fault_plan.strip():
            # A typo'd plan fails the node's construction.
            from .faults import FaultPlan

            FaultPlan.parse(self.fault_plan, seed=self.fault_seed)
        if not (0.0 <= self.trace_sample <= 1.0):
            raise ValueError("trace_sample must be within [0, 1]")
        if self.trace_max_mb <= 0:
            raise ValueError("trace_max_mb must be positive")
        if self.trace_retain_segments < 1:
            raise ValueError("trace_retain_segments must be >= 1 "
                             "(1 = the legacy single .1 generation)")
        if self.trace_retain_mb <= 0:
            raise ValueError("trace_retain_mb must be positive")
        if not (0.0 <= self.trace_tail_sample <= 1.0):
            raise ValueError("trace_tail_sample must be within [0, 1] "
                             "(1.0 disables tail sampling)")
        if self.trace_tail_slow_ms < 0:
            raise ValueError("trace_tail_slow_ms must be >= 0")
        if self.slo_rules.strip():
            # A typo'd objective, or a rules file that is missing or
            # does not parse, fails the node's construction.
            from .observe.slo import parse_rules

            parse_rules(self.slo_rules)
        if self.slo_webhook_url and not (
                self.slo_webhook_url.startswith("http://")
                or self.slo_webhook_url.startswith("https://")):
            raise ValueError(
                f"slo_webhook_url {self.slo_webhook_url!r} must be an "
                f"http(s) URL")
        if self.slo_alert_log_mb <= 0:
            raise ValueError("slo_alert_log_mb must be positive")
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
        # The runner reads the checkpoint switch a trial, the train
        # worker the prefetch switch when its loop starts.
        if self.checkpoint_trials:
            os.environ[self.env_name("checkpoint_trials")] = "1"
        else:
            os.environ.pop(self.env_name("checkpoint_trials"), None)
        os.environ[self.env_name("advisor_prefetch")] = \
            "1" if self.advisor_prefetch else "0"
        # The ParamStore reads the write-behind switch a save.
        os.environ[self.env_name("params_write_behind")] = \
            "1" if self.params_write_behind else "0"
        # The dataset and staging caches read their budgets per call.
        os.environ[self.env_name("dataset_cache_bytes")] = \
            str(self.dataset_cache_bytes)
        os.environ[self.env_name("stage_cache_bytes")] = \
            str(self.stage_cache_bytes)
        os.environ[self.env_name("stage_bytes")] = str(self.stage_bytes)
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
        os.environ[self.env_name("serving_packed_wire")] = \
            packed_wire_mode(self.serving_packed_wire)
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
        os.environ[self.env_name("serving_pipeline")] = \
            "auto" if self.serving_pipeline is None \
            else ("1" if self.serving_pipeline else "0")
        for f in ("generate_page_size", "generate_pool_pages",
                  "generate_decode_batch", "generate_max_new"):
            os.environ[self.env_name(f)] = str(getattr(self, f))
        # The platform builds the autoscaler and the SLO engine from
        # these; the switches, the table and the rules pop when off
        # (absent = disarmed).
        if self.autoscale:
            os.environ[self.env_name("autoscale")] = "1"
        else:
            os.environ.pop(self.env_name("autoscale"), None)
        os.environ[self.env_name("autoscale_dry_run")] = \
            "1" if self.autoscale_dry_run else "0"
        for f in ("autoscale_max_replicas", "autoscale_step",
                  "autoscale_up_cooldown_s", "autoscale_down_cooldown_s",
                  "autoscale_queue_high", "autoscale_queue_low",
                  "autoscale_p99_high_ms", "autoscale_mfu_floor",
                  "autoscale_idle_sweeps",
                  "autoscale_predict_horizon_s",
                  "autoscale_predict_ramp_ratio",
                  "slo_alert_log_mb"):
            os.environ[self.env_name(f)] = str(getattr(self, f))
        for f in ("autoscale_periodicity", "slo_rules",
                  "slo_webhook_url"):
            if getattr(self, f).strip():
                os.environ[self.env_name(f)] = getattr(self, f)
            else:
                os.environ.pop(self.env_name(f), None)
        # The fault plane arms from these when its first site is built;
        # an empty plan pops both (absent = disarmed).
        if self.fault_plan.strip():
            os.environ[self.env_name("fault_plan")] = self.fault_plan
            os.environ[self.env_name("fault_seed")] = str(self.fault_seed)
        else:
            os.environ.pop(self.env_name("fault_plan"), None)
            os.environ.pop(self.env_name("fault_seed"), None)
        if self.cluster_fabric:
            os.environ[self.env_name("cluster_fabric")] = "1"
        else:
            os.environ.pop(self.env_name("cluster_fabric"), None)
        for f in ("cluster_probe_timeout_s", "cluster_locality_boost"):
            os.environ[self.env_name(f)] = str(getattr(self, f))
        os.environ[self.env_name("metrics")] = "1" if self.metrics else "0"
        for f in ("trace_sample", "trace_max_mb", "trace_retain_segments",
                  "trace_retain_mb", "trace_tail_slow_ms"):
            os.environ[self.env_name(f)] = str(getattr(self, f))
        # Tail sampling off (1.0) pops its variable, as the reference.
        if self.trace_tail_sample < 1.0:
            os.environ[self.env_name("trace_tail_sample")] = \
                str(self.trace_tail_sample)
        else:
            os.environ.pop(self.env_name("trace_tail_sample"), None)
        if self.metrics_exemplars:
            os.environ[self.env_name("metrics_exemplars")] = "1"
        else:
            os.environ.pop(self.env_name("metrics_exemplars"), None)
