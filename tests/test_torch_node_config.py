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


def test_serve_refuses_a_node_over_several_processes():
    """The multi-process triple parses as the reference's, and ``serve``
    then refuses it, naming the ROADMAP item, before it starts
    anything."""
    with pytest.raises(SystemExit) as e:
        pmain.main(["serve", "--coordinator", "127.0.0.1:1",
                    "--num-processes", "2", "--process-id", "0"])
    assert "queue 1 item 8" in str(e.value.code)
