"""The port's ``NodeConfig`` node fields and its CLI held against the
reference's (after ``tests/test_config.py``).

``from_env`` on the same environment and CLI overrides gives the same
fields (or the same error), ``validate`` refuses the same values with
the same message, ``apply_env`` exports the same variables, and the two
packages' argument parsers accept and refuse the same command lines
with the same parsed arguments.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import os

import pytest

import rafiki_torch.__main__ as pmain
import rafiki_tpu.__main__ as rmain
from rafiki_torch import config as pconfig
from rafiki_tpu import config as rconfig

NODE_FIELDS = ["workdir", "port", "n_chips", "bus_uri",
               "supervise_interval", "log_level", "trace_dir",
               "coordinator", "num_processes", "process_id",
               "max_chip_share", "worker_reregister", "node_lease",
               "bus_retry_base_s", "bus_retry_total_s", "metrics_port"]
CONFIGS = (pconfig.NodeConfig, rconfig.NodeConfig)


def test_node_defaults_and_names_equal_the_reference():
    port, ref = pconfig.NodeConfig(), rconfig.NodeConfig()
    for f in NODE_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
        assert pconfig.NodeConfig.env_name(f) == \
            rconfig.NodeConfig.env_name(f), f
    # The one field the reference reads without a NodeConfig field.
    assert port.chip_share is True
    assert pconfig.NodeConfig.env_name("chip_share") == \
        "RAFIKI_TPU_CHIP_SHARE"


def _outcome(cls, env, overrides):
    try:
        cfg = cls.from_env(env=env, **overrides)
    except ValueError as e:
        return str(e)
    return {f: getattr(cfg, f) for f in NODE_FIELDS}


@pytest.mark.parametrize("env,overrides", [
    ({}, {}),
    ({"RAFIKI_TPU_PORT": "8080", "RAFIKI_TPU_N_CHIPS": "4",
      "RAFIKI_TPU_BUS_URI": "tcp://10.0.0.1:6380",
      "RAFIKI_TPU_SUPERVISE_INTERVAL": "2.5",
      "RAFIKI_TPU_TRACE_DIR": "/tmp/traces",
      "RAFIKI_TPU_MAX_CHIP_SHARE": "2",
      "RAFIKI_TPU_NODE_LEASE": "30",
      "RAFIKI_TPU_WORKER_REREGISTER": "1.0",
      "RAFIKI_TPU_BUS_RETRY_TOTAL_S": "3",
      "RAFIKI_TPU_METRICS_PORT": "9100"}, {}),
    ({"RAFIKI_TPU_PORT": "8080"}, {"port": 9090, "workdir": None}),
    ({"RAFIKI_TPU_WORKDIR": "/w", "RAFIKI_TPU_LOG_LEVEL": "DEBUG"},
     {"bus_uri": "memory://", "n_chips": None}),
    ({}, {"coordinator": "h:1234", "num_processes": 2, "process_id": 0}),
    ({"RAFIKI_TPU_PORT": "not-a-number"}, {}),
    ({"RAFIKI_TPU_NODE_LEASE": "soon"}, {}),
    ({}, {"port": -1}), ({}, {"port": 70000}), ({}, {"n_chips": 0}),
    ({}, {"log_level": "loud"}), ({}, {"bus_uri": "redis://x"}),
    ({}, {"coordinator": "h:1"}), ({}, {"num_processes": 2}),
    ({}, {"supervise_interval": -1.0}), ({}, {"node_lease": 0.0}),
    ({}, {"worker_reregister": 0.0}), ({}, {"max_chip_share": 0}),
    ({}, {"bus_retry_base_s": 0.0}), ({}, {"bus_retry_total_s": -1.0}),
    ({}, {"metrics_port": 70000})])
def test_from_env_and_validate_equal_the_reference(env, overrides):
    got = [_outcome(cls, env, overrides) for cls in CONFIGS]
    assert got[0] == got[1]


EXPORTED = ["RAFIKI_TPU_TRACE_DIR", "RAFIKI_TPU_MAX_CHIP_SHARE",
            "RAFIKI_TPU_WORKER_REREGISTER", "RAFIKI_TPU_NODE_LEASE",
            "RAFIKI_TPU_BUS_RETRY_BASE_S", "RAFIKI_TPU_BUS_RETRY_TOTAL_S",
            "RAFIKI_TPU_METRICS_PORT"]


@pytest.mark.parametrize("overrides", [
    {}, {"trace_dir": "/t", "max_chip_share": 3, "node_lease": 9.5,
         "worker_reregister": 0.25, "bus_retry_base_s": 0.01,
         "bus_retry_total_s": 0.0, "metrics_port": 9200},
    {"metrics_port": 0}])
def test_apply_env_exports_as_the_reference(overrides):
    saved = dict(os.environ)
    exported = []
    try:
        for cls in CONFIGS:
            for k in EXPORTED + ["RAFIKI_TPU_CHIP_SHARE"]:
                os.environ.pop(k, None)
            os.environ["RAFIKI_TPU_METRICS_PORT"] = "1234"  # popped at 0
            cls.from_env(env={}, **overrides).apply_env()
            exported.append({k: os.environ.get(k) for k in EXPORTED})
        for k in EXPORTED:
            os.environ.pop(k, None)
        pconfig.NodeConfig.from_env(env={}, chip_share=False).apply_env()
        port_share = os.environ.get("RAFIKI_TPU_CHIP_SHARE")
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert exported[0] == exported[1]
    assert port_share == "0"


def test_chip_share_reaches_the_services_manager(tmp_path, monkeypatch):
    """``RAFIKI_TPU_CHIP_SHARE=0`` turns the time-sliced tier off, as the
    reference's manager reads it, and ``RAFIKI_TPU_NODE_LEASE`` is read
    when the manager is built."""
    from rafiki_torch.platform import LocalPlatform

    monkeypatch.setenv("RAFIKI_TPU_NODE_LEASE", "7.5")
    p = LocalPlatform(workdir=str(tmp_path / "n"), supervise_interval=0,
                      device="cpu")
    try:
        assert p.services.NODE_LEASE == 7.5
        assert p.services._sharing_ok()
        monkeypatch.setenv("RAFIKI_TPU_CHIP_SHARE", "0")
        assert not p.services._sharing_ok()
    finally:
        p.shutdown()


def _parsed(module, argv, monkeypatch):
    """What ``module.main(argv)`` hands its subcommand, or how it exits."""
    seen = []
    for name in ("_serve", "_join", "_broker"):
        monkeypatch.setattr(module, name,
                            lambda args, name=name: seen.append(
                                (name, {k: v for k, v in vars(args).items()
                                        if k != "fn"})))
    try:
        module.main(argv)
    except SystemExit as e:
        return ("exit", e.code)
    return seen


@pytest.mark.parametrize("argv", [
    ["serve"], ["serve", "--workdir", "/w", "--port", "0", "--chips", "1",
                "--bus", "tcp://127.0.0.1:6380", "--log-level", "debug"],
    ["serve", "--coordinator", "h:1", "--num-processes", "2",
     "--process-id", "0"],
    ["serve", "--coordinator", "h:1"], ["serve", "--process-id", "0"],
    ["serve", "--port", "x"], ["serve", "--nope"],
    ["join", "--workdir", "/w", "--bus", "tcp://h:1", "--train-job", "t"],
    ["join", "--workdir", "/w", "--bus", "tcp://h:1",
     "--inference-job", "i", "--chips", "1", "--chips-per-trial", "1",
     "--timeout", "5", "--log-level", "warning"],
    ["join", "--workdir", "/w", "--bus", "tcp://h:1"],
    ["join", "--workdir", "/w", "--bus", "tcp://h:1", "--train-job", "t",
     "--inference-job", "i"],
    ["join", "--bus", "tcp://h:1", "--train-job", "t"],
    ["broker"], ["broker", "--host", "0.0.0.0", "--port", "0", "--python"],
    ["broker", "--port", "many"], [], ["nope"]])
def test_the_cli_parses_as_the_reference(argv, monkeypatch, capsys):
    got = [_parsed(m, list(argv), monkeypatch) for m in (pmain, rmain)]
    capsys.readouterr()
    assert got[0] == got[1]


def test_serve_flags_initialize_a_node_over_several_processes(
        monkeypatch, tmp_path):
    """The multi-process triple parses as the reference's, and ``serve``
    joins the process group with it before the platform is built (ref
    :54-60), and leaves the group when the platform goes, as the
    reference's ``jax.distributed.initialize`` comes first.
    (``tests/test_torch_dist.py`` runs a real pair.)"""
    from rafiki_torch import platform as pplatform
    from rafiki_torch.parallel import dist

    calls = []

    class _Node:
        process_index, num_processes, backend = 1, 2, "gloo"
        devices, local = ["a", "b"], ["b"]

    def fake_init(coordinator, num_processes, process_id):
        calls.append(("init", coordinator, num_processes, process_id))
        return _Node()

    def fake_platform(*args, **kwargs):
        calls.append(("platform", dist.is_initialized()))
        raise RuntimeError("stop before serving")

    monkeypatch.setattr(dist, "initialize", fake_init)
    monkeypatch.setattr(dist, "shutdown", lambda: calls.append(("down",)))
    monkeypatch.setattr(pplatform.LocalPlatform, "from_config",
                        staticmethod(fake_platform))
    monkeypatch.setenv("RAFIKI_TPU_PLATFORM", "cpu")
    saved = dict(os.environ)  # serve's apply_env exports the config
    try:
        with pytest.raises(RuntimeError, match="stop before serving"):
            pmain.main(["serve", "--workdir", str(tmp_path), "--port", "0",
                        "--coordinator", "127.0.0.1:1", "--num-processes",
                        "2", "--process-id", "1"])
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert calls == [("init", "127.0.0.1:1", 2, 1), ("platform", False),
                     ("down",)]


# --- The fields of the fault plane, the cluster fabric, observability,
# the pipelined worker and the generation engine ---

NEW_FIELDS = ["serving_pipeline", "generate_page_size",
              "generate_pool_pages", "generate_decode_batch",
              "generate_max_new", "fault_plan", "fault_seed",
              "cluster_fabric", "cluster_probe_timeout_s",
              "cluster_locality_boost", "metrics", "trace_sample",
              "trace_max_mb", "trace_retain_segments", "trace_retain_mb",
              "trace_tail_sample", "trace_tail_slow_ms",
              "metrics_exemplars", "checkpoint_trials", "advisor_prefetch",
              "params_write_behind"]


@pytest.mark.parametrize("field", NEW_FIELDS)
def test_new_field_default_and_name_equal_the_reference(field):
    assert getattr(pconfig.NodeConfig(), field) == \
        getattr(rconfig.NodeConfig(), field)
    assert pconfig.NodeConfig.env_name(field) == \
        rconfig.NodeConfig.env_name(field)
    assert pconfig.NodeConfig._field_types()[field] is \
        rconfig.NodeConfig._field_types()[field]


def _new_outcome(cls, env, overrides):
    try:
        cfg = cls.from_env(env=env, **overrides)
    except ValueError as e:
        return str(e)
    return {f: getattr(cfg, f) for f in NEW_FIELDS}


@pytest.mark.parametrize("env,overrides", [
    ({}, {}),
    ({"RAFIKI_TPU_SERVING_PIPELINE": "auto"}, {}),
    ({"RAFIKI_TPU_SERVING_PIPELINE": "0"}, {}),
    ({"RAFIKI_TPU_SERVING_PIPELINE": "on"}, {}),
    ({"RAFIKI_TPU_CLUSTER_FABRIC": "1",
      "RAFIKI_TPU_CLUSTER_PROBE_TIMEOUT_S": "2.0",
      "RAFIKI_TPU_CLUSTER_LOCALITY_BOOST": "4",
      "RAFIKI_TPU_FAULT_PLAN": "worker.crash:n=1;bus.delay:p=0.02,ms=2",
      "RAFIKI_TPU_FAULT_SEED": "11", "RAFIKI_TPU_METRICS": "0",
      "RAFIKI_TPU_METRICS_EXEMPLARS": "yes",
      "RAFIKI_TPU_TRACE_SAMPLE": "0.5", "RAFIKI_TPU_TRACE_MAX_MB": "8",
      "RAFIKI_TPU_TRACE_RETAIN_SEGMENTS": "2",
      "RAFIKI_TPU_TRACE_RETAIN_MB": "32",
      "RAFIKI_TPU_TRACE_TAIL_SAMPLE": "0.25",
      "RAFIKI_TPU_TRACE_TAIL_SLOW_MS": "100",
      "RAFIKI_TPU_GENERATE_PAGE_SIZE": "32",
      "RAFIKI_TPU_GENERATE_POOL_PAGES": "512",
      "RAFIKI_TPU_GENERATE_DECODE_BATCH": "4",
      "RAFIKI_TPU_GENERATE_MAX_NEW": "64"}, {}),
    ({"RAFIKI_TPU_CLUSTER_FABRIC": "auto"}, {}),
    ({"RAFIKI_TPU_CKPT": "1", "RAFIKI_TPU_ADVISOR_PREFETCH": "0"}, {}),
    ({"RAFIKI_TPU_PARAMS_WRITE_BEHIND": "0"}, {}),
    ({"RAFIKI_TPU_PARAMS_WRITE_BEHIND": "maybe"}, {}),
    ({"RAFIKI_TPU_CKPT": "auto"}, {}),
    ({"RAFIKI_TPU_CKPT": "off", "RAFIKI_TPU_ADVISOR_PREFETCH": "yes"},
     {"checkpoint_trials": True}),
    ({"RAFIKI_TPU_FAULT_SEED": "x"}, {}),
    ({"RAFIKI_TPU_FAULT_PLAN": "bus.explode"}, {}),
    ({}, {"fault_plan": "worker.crash:N=2"}),
    ({}, {"fault_plan": "bus.delay:p=0.5,n=3"}),
    ({}, {"cluster_probe_timeout_s": 0.0}),
    ({}, {"cluster_locality_boost": 0.5}),
    ({}, {"trace_sample": 1.5}), ({}, {"trace_max_mb": 0.0}),
    ({}, {"trace_retain_segments": 0}), ({}, {"trace_retain_mb": -1.0}),
    ({}, {"trace_tail_sample": -0.1}), ({}, {"trace_tail_slow_ms": -1.0}),
    ({}, {"generate_page_size": 0}), ({}, {"generate_pool_pages": 1}),
    ({}, {"generate_decode_batch": 0}), ({}, {"generate_max_new": 0}),
    ({}, {"serving_pipeline": False, "cluster_fabric": True,
          "fault_plan": "http.error:route=/predict,n=1"})])
def test_new_fields_parse_and_validate_as_the_reference(env, overrides):
    got = [_new_outcome(cls, env, overrides) for cls in CONFIGS]
    assert got[0] == got[1]


NEW_EXPORTED = ["RAFIKI_TPU_SERVING_PIPELINE", "RAFIKI_TPU_FAULT_PLAN",
                "RAFIKI_TPU_FAULT_SEED", "RAFIKI_TPU_CLUSTER_FABRIC",
                "RAFIKI_TPU_CLUSTER_PROBE_TIMEOUT_S",
                "RAFIKI_TPU_CLUSTER_LOCALITY_BOOST", "RAFIKI_TPU_METRICS",
                "RAFIKI_TPU_METRICS_EXEMPLARS", "RAFIKI_TPU_TRACE_SAMPLE",
                "RAFIKI_TPU_TRACE_MAX_MB",
                "RAFIKI_TPU_TRACE_RETAIN_SEGMENTS",
                "RAFIKI_TPU_TRACE_RETAIN_MB",
                "RAFIKI_TPU_TRACE_TAIL_SAMPLE",
                "RAFIKI_TPU_TRACE_TAIL_SLOW_MS",
                "RAFIKI_TPU_GENERATE_PAGE_SIZE",
                "RAFIKI_TPU_GENERATE_POOL_PAGES",
                "RAFIKI_TPU_GENERATE_DECODE_BATCH",
                "RAFIKI_TPU_GENERATE_MAX_NEW", "RAFIKI_TPU_CKPT",
                "RAFIKI_TPU_ADVISOR_PREFETCH",
                "RAFIKI_TPU_PARAMS_WRITE_BEHIND"]


@pytest.mark.parametrize("overrides", [
    {}, {"serving_pipeline": True, "cluster_fabric": True,
         "cluster_probe_timeout_s": 0.5, "cluster_locality_boost": 2.0,
         "fault_plan": "node.kill:op=vm/b,n=1", "fault_seed": 4,
         "metrics": False, "metrics_exemplars": True,
         "trace_sample": 0.1, "trace_tail_sample": 0.5,
         "trace_retain_segments": 2, "generate_max_new": 32,
         "checkpoint_trials": True, "advisor_prefetch": False,
         "params_write_behind": False},
    {"serving_pipeline": False, "trace_tail_sample": 1.0}])
def test_new_fields_round_trip_through_apply_env(overrides):
    saved = dict(os.environ)
    exported, back = [], []
    try:
        for cls in CONFIGS:
            for k in NEW_EXPORTED:
                os.environ[k] = "stale"
            cfg = cls.from_env(env={}, **overrides)
            cfg.apply_env()
            exported.append({k: os.environ.get(k) for k in NEW_EXPORTED})
            # What apply_env wrote reads back as the same config.
            again = cls.from_env(env=dict(os.environ))
            back.append({f: getattr(again, f) == getattr(cfg, f)
                         for f in NEW_FIELDS})
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert exported[0] == exported[1]
    assert all(all(b.values()) for b in back), back


# --- The serving control loop's fields: the autoscaler and the SLO plane ---

LOOP_FIELDS = ["autoscale", "autoscale_dry_run", "autoscale_max_replicas",
               "autoscale_step", "autoscale_up_cooldown_s",
               "autoscale_down_cooldown_s", "autoscale_queue_high",
               "autoscale_queue_low", "autoscale_p99_high_ms",
               "autoscale_mfu_floor", "autoscale_idle_sweeps",
               "autoscale_predict_horizon_s", "autoscale_periodicity",
               "autoscale_predict_ramp_ratio", "slo_rules",
               "slo_webhook_url", "slo_alert_log_mb"]


@pytest.mark.parametrize("field", LOOP_FIELDS)
def test_loop_field_default_and_name_equal_the_reference(field):
    assert getattr(pconfig.NodeConfig(), field) == \
        getattr(rconfig.NodeConfig(), field)
    assert pconfig.NodeConfig.env_name(field) == \
        rconfig.NodeConfig.env_name(field)
    assert pconfig.NodeConfig._field_types()[field] is \
        rconfig.NodeConfig._field_types()[field]


def _loop_outcome(cls, env, overrides):
    try:
        cfg = cls.from_env(env=env, **overrides)
    except ValueError as e:
        return str(e)
    return {f: getattr(cfg, f) for f in LOOP_FIELDS}


@pytest.fixture()
def tables(tmp_path):
    good = tmp_path / "good.json"
    good.write_text('{"period_s": 60, "bin_s": 30, "qps": [1.0, 2.0]}')
    bad = tmp_path / "bad.json"
    bad.write_text('{"period_s": 60, "bin_s": 30, "qps": [1.0]}')
    rules = tmp_path / "rules.json"
    rules.write_text('{"objectives": [{"name": "a", "type": "ratio", '
                     '"target": 0.99}]}')
    return {"good": str(good), "bad": str(bad), "rules": str(rules),
            "absent": str(tmp_path / "absent.json")}


@pytest.mark.parametrize("env,overrides", [
    ({}, {}),
    ({"RAFIKI_TPU_AUTOSCALE": "1", "RAFIKI_TPU_AUTOSCALE_DRY_RUN": "yes",
      "RAFIKI_TPU_AUTOSCALE_MAX_REPLICAS": "2",
      "RAFIKI_TPU_AUTOSCALE_STEP": "2",
      "RAFIKI_TPU_AUTOSCALE_UP_COOLDOWN_S": "1",
      "RAFIKI_TPU_AUTOSCALE_DOWN_COOLDOWN_S": "4",
      "RAFIKI_TPU_AUTOSCALE_QUEUE_HIGH": "0.5",
      "RAFIKI_TPU_AUTOSCALE_QUEUE_LOW": "0.1",
      "RAFIKI_TPU_AUTOSCALE_P99_HIGH_MS": "80",
      "RAFIKI_TPU_AUTOSCALE_MFU_FLOOR": "0",
      "RAFIKI_TPU_AUTOSCALE_IDLE_SWEEPS": "5",
      "RAFIKI_TPU_AUTOSCALE_PREDICT_HORIZON_S": "30",
      "RAFIKI_TPU_AUTOSCALE_PREDICT_RAMP_RATIO": "2",
      "RAFIKI_TPU_AUTOSCALE_PERIODICITY": "@good",
      "RAFIKI_TPU_SLO_RULES": "p99:p99<50ms,window=60;a:ratio>=0.99",
      "RAFIKI_TPU_SLO_WEBHOOK_URL": "http://127.0.0.1:9/hook",
      "RAFIKI_TPU_SLO_ALERT_LOG_MB": "2"}, {}),
    ({"RAFIKI_TPU_SLO_RULES": "@rules"}, {}),
    ({"RAFIKI_TPU_AUTOSCALE": "auto"}, {}),
    ({"RAFIKI_TPU_AUTOSCALE_STEP": "two"}, {}),
    ({}, {"autoscale_max_replicas": 0}), ({}, {"autoscale_step": 0}),
    ({}, {"autoscale_up_cooldown_s": -1.0}),
    ({}, {"autoscale_down_cooldown_s": -1.0}),
    ({}, {"autoscale_queue_low": 0.5, "autoscale_queue_high": 0.4}),
    ({}, {"autoscale_queue_high": 1.5}),
    ({}, {"autoscale_p99_high_ms": -1.0}),
    ({}, {"autoscale_mfu_floor": -0.1}), ({}, {"autoscale_idle_sweeps": 0}),
    ({}, {"autoscale_predict_horizon_s": -1.0}),
    ({}, {"autoscale_predict_ramp_ratio": 0.9}),
    ({}, {"autoscale_periodicity": "@bad"}),
    ({}, {"autoscale_periodicity": "@absent"}),
    ({}, {"slo_rules": "x:p99<50ms,bogus=1"}),
    ({}, {"slo_rules": "@absent"}),
    ({}, {"slo_webhook_url": "ftp://pager"}),
    ({}, {"slo_alert_log_mb": 0.0})])
def test_loop_fields_parse_and_validate_as_the_reference(env, overrides,
                                                         tables):
    def sub(v):
        return tables[v[1:]] if isinstance(v, str) and v.startswith("@") \
            else v

    env = {k: sub(v) for k, v in env.items()}
    overrides = {k: sub(v) for k, v in overrides.items()}
    got = [_loop_outcome(cls, env, overrides) for cls in CONFIGS]
    assert got[0] == got[1]


LOOP_EXPORTED = [pconfig.NodeConfig.env_name(f) for f in LOOP_FIELDS]


@pytest.mark.parametrize("overrides", [
    {}, {"autoscale": True, "autoscale_dry_run": True,
         "autoscale_max_replicas": 2, "autoscale_up_cooldown_s": 1.0,
         "autoscale_periodicity": "@good",
         "slo_rules": "p99:p99<50ms", "slo_webhook_url": "https://x/y",
         "slo_alert_log_mb": 4.0}])
def test_loop_fields_round_trip_through_apply_env(overrides, tables):
    overrides = {k: tables[v[1:]] if isinstance(v, str) and
                 v.startswith("@") else v for k, v in overrides.items()}
    saved = dict(os.environ)
    exported, back = [], []
    try:
        for cls in CONFIGS:
            for k in LOOP_EXPORTED:
                os.environ[k] = "stale"
            cfg = cls.from_env(env={}, **overrides)
            cfg.apply_env()
            exported.append({k: os.environ.get(k) for k in LOOP_EXPORTED})
            again = cls.from_env(env={k: v for k, v in os.environ.items()
                                      if k in LOOP_EXPORTED})
            back.append({f: getattr(again, f) == getattr(cfg, f)
                         for f in LOOP_FIELDS})
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert exported[0] == exported[1]
    assert all(all(b.values()) for b in back), back


# --- The packed-wire switch ---

def test_serving_packed_wire_default_and_name_equal_the_reference():
    field = "serving_packed_wire"
    assert pconfig.NodeConfig().serving_packed_wire == \
        rconfig.NodeConfig().serving_packed_wire == "on"
    assert pconfig.NodeConfig.env_name(field) == \
        rconfig.NodeConfig.env_name(field) == \
        "RAFIKI_TPU_SERVING_PACKED_WIRE"
    assert pconfig.NodeConfig._field_types()[field] is \
        rconfig.NodeConfig._field_types()[field]


@pytest.mark.parametrize("raw", ["on", "off", "compat", "", "1", "0",
                                 " OFF ", "yes", "no", "Compat", "offf",
                                 "compatible", "2"])
def test_serving_packed_wire_validates_and_exports_as_the_reference(raw):
    """``validate`` refuses the same spellings with the same message,
    and ``apply_env`` exports the same normalised mode."""
    key = "RAFIKI_TPU_SERVING_PACKED_WIRE"
    saved = dict(os.environ)
    got = []
    try:
        for cls in CONFIGS:
            os.environ[key] = "stale"
            try:
                cls.from_env(env={}, serving_packed_wire=raw).apply_env()
            except ValueError as e:
                got.append(("refused", str(e)))
                continue
            got.append(("exported", os.environ.get(key)))
            again = cls.from_env(env=dict(os.environ))
            assert again.serving_packed_wire == os.environ[key]
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert got[0] == got[1]
    assert got[0][0] == ("refused" if raw.strip().lower() in
                         ("offf", "compatible", "2") else "exported")
