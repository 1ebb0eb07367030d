"""Checkpoint resume in the port, held against the reference on the CPU.

- ``CheckpointManager``: each package's manager reads the directory the
  other wrote (the same steps after pruning, the same arrays, the same
  file bytes), and a directory swept away under it does not err a save.
- Resume: for every model family that resumes in the reference
  (``TorchModel`` with the feed-forward net, the ViT, DenseNet and its
  BatchNorm statistics, ENAS; the transformer and BiLSTM taggers; the
  MLPs), a run interrupted after an epoch and resumed is bitwise the
  uninterrupted run on the CPU, as is a rung chain under one
  ``schedule_total_epochs``. A checkpoint of another structure starts
  fresh with a warning; an early-stopped one trains nothing further.
- ``schedule_total_epochs`` against the reference: ``TorchFeedForward``
  trained 2 epochs under a 6-epoch horizon, and a 1-then-3-epoch rung
  chain, against ``JaxFeedForward`` doing the same, within
  ``test_torch_feedforward.py``'s tolerances (the loss within
  ``LOSS_ATOL`` an epoch, each tensor's update within ``UPDATE_RTOL`` of
  its size). Those tolerances come from 8 steps at batch 32, so the
  set here has 128 images: 4 steps an epoch, 8 over 2 epochs and 12
  over the chain's 3.
- The runner's crash resume (``RAFIKI_TPU_CKPT=1``): a trial that died
  after epoch 1 is proposed again, logs ``resumed from checkpoint epoch
  1``, trains only epoch 2 and ends where the uninterrupted trial ends;
  its directory goes once the trial completes.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import logging
import os

import numpy as np
import pytest

from rafiki_tpu.model.knobs import FixedKnob as JaxFixedKnob
from rafiki_tpu.model.knobs import IntegerKnob as JaxIntegerKnob
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.models.feedforward import JaxFeedForward
from rafiki_tpu.store import CheckpointManager as RefManager
from rafiki_torch.advisor.base import Proposal
from rafiki_torch.datasets import (make_synthetic_corpus_dataset,
                                   make_synthetic_image_dataset,
                                   make_synthetic_tabular_dataset)
from rafiki_torch.model import FixedKnob, IntegerKnob
from rafiki_torch.model.logger import logger
from rafiki_torch.models import (TorchDenseNet, TorchFeedForward,
                                 TorchPosTagger, TorchTabMlpClf,
                                 TorchTransformerTagger, TorchViT)
from rafiki_torch.store import CheckpointManager, MetaStore, ParamStore
from rafiki_torch.worker.runner import TrialRunner
from test_torch_feedforward import LOSS_ATOL, UPDATE_RTOL, _params
from test_torch_zoo import TorchTinyEnas, _knobs_for

# --- CheckpointManager ---


def _arrays(step):
    return {"leaf_0": np.full((3, 2), step, np.float32),
            "leaf_1": np.asarray(step, np.int64),
            "es_best_loss": np.asarray(0.5 + step, np.float64),
            "es_bad_epochs": np.asarray(step % 2, np.int64)}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_managers_read_each_others_directories(tmp_path, writer):
    cls_w, cls_r = ((CheckpointManager, RefManager) if writer == "port"
                    else (RefManager, CheckpointManager))
    d = str(tmp_path / "ck")
    mgr = cls_w(d, keep_last=2)
    assert mgr.latest_step() is None
    for step in range(4):
        mgr.save(step, _arrays(step))
    other = cls_r(d, keep_last=2)
    assert mgr.steps() == other.steps() == [2, 3]
    for step in (2, 3, None):
        s1, a1 = mgr.restore(step)
        s2, a2 = other.restore(step)
        assert s1 == s2
        assert sorted(a1) == sorted(a2)
        for k in a1:
            assert a1[k].dtype == a2[k].dtype, k
            np.testing.assert_array_equal(a1[k], a2[k])
    # The same dict makes the same file in both packages.
    d2 = str(tmp_path / "ck2")
    cls_r(d2).save(3, _arrays(3))
    with open(os.path.join(d, "ckpt_3.safetensors"), "rb") as f1, \
            open(os.path.join(d2, "ckpt_3.safetensors"), "rb") as f2:
        assert f1.read() == f2.read()


def test_manager_restores_a_given_step_and_prunes(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=3)
    mgr.save(5, {"x": np.ones((2,))})
    mgr.save(7, {"x": np.zeros((2,))})
    step, arrs = mgr.restore(5)
    assert step == 5 and arrs["x"].sum() == 2
    assert mgr.restore()[0] == 7
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_a_swept_directory_does_not_err_the_save(tmp_path):
    import shutil

    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d)
    mgr.save(0, {"x": np.ones((2,))})
    shutil.rmtree(d)
    assert mgr.steps() == [] and mgr.latest_step() is None
    mgr.save(1, {"x": np.zeros((2,))})
    assert mgr.steps() == [1]
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]


# --- Resume, bitwise, for each family ---


class _Crash(RuntimeError):
    pass


def _values(recs):
    return [r["values"] for r in recs if r.get("type") == "values"]


def _epochs(recs):
    return [v["epoch"] for v in _values(recs) if "epoch" in v]


def _run(make, path, crash_at=None, **kwargs):
    """Train a fresh model; ``crash_at`` raises when that epoch's record
    is logged. Returns (the model's parameters or None, the records)."""
    recs = []

    def sink(rec):
        recs.append(rec)
        if crash_at is not None and rec.get("type") == "values" \
                and rec.get("values", {}).get("epoch") == crash_at:
            raise _Crash(f"died after epoch {crash_at} was logged")

    prior = logger.current_sink()
    logger.set_sink(sink)
    try:
        model = make()
        try:
            model.train(path, **kwargs)
        except _Crash:
            return None, recs
        return {k: np.array(v) for k, v in model.dump_parameters().items()
                if not k.startswith("_")}, recs
    finally:
        logger.set_sink(prior)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return {
        "small": make_synthetic_image_dataset(
            str(root / "small"), n_train=96, n_val=32, image_shape=(8, 8, 1),
            n_classes=4, seed=0),
        "rgb8": make_synthetic_image_dataset(
            str(root / "rgb8"), n_train=48, n_val=16, image_shape=(8, 8, 3),
            n_classes=4, seed=1),
        "corpus": make_synthetic_corpus_dataset(
            str(root / "corpus"), n_train=48, n_val=16, vocab=200,
            n_tags=5, max_len=20, seed=0),
        "table": make_synthetic_tabular_dataset(
            str(root / "table"), n_train=64, n_val=32, n_features=6,
            n_classes=3, seed=0),
    }


FF = {"hidden_layer_count": 1, "hidden_layer_units": 16,
      "learning_rate": 3e-3, "batch_size": 32, "max_epochs": 3}
FAMILIES = {
    "feedforward": (TorchFeedForward, FF, "small"),
    "vit": (TorchViT, {"d_model": 16, "n_heads": 2, "patch": 4, "depth": 2,
                       "learning_rate": 3e-3, "weight_decay": 1e-4,
                       "batch_size": 16, "max_epochs": 3,
                       "early_stop_epochs": 5}, "rgb8"),
    "densenet": (TorchDenseNet, dict(_knobs_for("densenet"),
                                     batch_size=16, max_epochs=3), "rgb8"),
    "enas": (TorchTinyEnas, dict(_knobs_for("enas"), share_params=False,
                                 quick_train=False, batch_size=16,
                                 max_epochs=3), "rgb8"),
    "transformer_tagger": (TorchTransformerTagger,
                           {"d_model": 32, "n_heads": 2, "n_layers": 1,
                            "max_len": 20, "vocab_size": 500,
                            "dropout": 0.1, "learning_rate": 3e-3,
                            "batch_size": 16, "max_epochs": 3}, "corpus"),
    "bilstm_tagger": (TorchPosTagger,
                      {"embed_dim": 16, "hidden": 12, "vocab_size": 500,
                       "max_len": 20, "learning_rate": 1e-2,
                       "batch_size": 16, "max_epochs": 3, "seed": 0},
                      "corpus"),
    "mlp": (TorchTabMlpClf, {"hidden": 24, "depth": 2,
                             "learning_rate": 1e-2, "batch_size": 16,
                             "max_epochs": 3, "seed": 0}, "table"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_interrupted_then_resumed_is_the_uninterrupted_run(tmp_path, data,
                                                           family):
    cls, knobs, which = FAMILIES[family]
    path = data[which][0]

    def make(**over):
        return lambda: cls(device="cpu", **dict(knobs, **over))

    full, _ = _run(make(), path)
    ck = str(tmp_path / "ck")
    dead, _ = _run(make(), path, crash_at=2, checkpoint_dir=ck)
    assert dead is None and CheckpointManager(ck).steps() == [0, 1]
    resumed, recs = _run(make(), path, checkpoint_dir=ck)
    assert {"msg": "resumed from checkpoint epoch 1"} in _values(recs)
    assert _epochs(recs) == [2]
    _same(full, resumed)

    # A rung chain: 1 epoch with its final state kept, then the whole
    # budget resumed, under one 3-epoch schedule.
    chain = str(tmp_path / "chain")
    _run(make(max_epochs=1), path, checkpoint_dir=chain,
         checkpoint_final_epoch=True, schedule_total_epochs=3)
    top, recs = _run(make(), path, checkpoint_dir=chain,
                     checkpoint_final_epoch=True, schedule_total_epochs=3)
    assert _epochs(recs) == [1, 2]
    _same(full, top)


def test_a_checkpoint_of_another_structure_starts_fresh(tmp_path, data,
                                                        caplog):
    """Another knob configuration reusing the directory: wider layers
    (same leaf count, other shapes), then one layer more (another leaf
    count). Each run starts fresh, warns, and is the uninterrupted
    run."""
    path = data["table"][0]
    knobs = FAMILIES["mlp"][1]
    ck = str(tmp_path / "ck")
    _run(lambda: TorchTabMlpClf(device="cpu", **dict(knobs, hidden=32)),
         path, checkpoint_dir=ck, checkpoint_final_epoch=True)
    for over, warning in (({}, "incompatible leaf shapes; starting fresh"),
                          ({"depth": 3}, "leaves, model has")):
        full, _ = _run(lambda: TorchTabMlpClf(device="cpu", **dict(
            knobs, **over)), path)
        caplog.clear()
        with caplog.at_level(logging.WARNING,
                             "rafiki_torch.model.loop_ckpt"):
            fresh, recs = _run(lambda: TorchTabMlpClf(device="cpu", **dict(
                knobs, **over)), path, checkpoint_dir=ck)
        assert warning in caplog.text
        assert _epochs(recs) == [0, 1, 2]
        _same(full, fresh)


def test_an_early_stopped_checkpoint_trains_nothing_further(tmp_path,
                                                            data):
    """At learning rate 0 the loss never improves, so early stopping at
    1 bad epoch ends the run after epoch 1; resumed under a larger
    budget, the run trains no epoch and keeps the saved parameters."""
    path = data["small"][0]
    knobs = dict(FF, learning_rate=0.0, early_stop_epochs=1, max_epochs=5)
    ck = str(tmp_path / "ck")
    first, recs = _run(lambda: TorchFeedForward(device="cpu", **knobs),
                       path, checkpoint_dir=ck, checkpoint_final_epoch=True)
    assert _epochs(recs) == [0, 1]
    saved = CheckpointManager(ck).restore()[1]
    assert saved["es_bad_epochs"].reshape(-1)[0] == 1
    again, recs = _run(lambda: TorchFeedForward(device="cpu", **dict(
        knobs, max_epochs=8)), path, checkpoint_dir=ck)
    assert _epochs(recs) == []
    assert {"msg": "resumed from checkpoint epoch 1"} in _values(recs)
    _same(first, again)


def test_checkpoint_every_epochs_and_a_failed_save(tmp_path, data,
                                                   monkeypatch):
    """The cadence skips the last epoch; a save that fails never errs
    the run."""
    path = data["small"][0]
    ck = str(tmp_path / "ck")
    _run(lambda: TorchFeedForward(device="cpu", **dict(FF, max_epochs=5)),
         path, checkpoint_dir=ck, checkpoint_every_epochs=2)
    assert CheckpointManager(ck).steps() == [1, 3]

    def refuse(self, step, arrays):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(CheckpointManager, "save", refuse)
    full, _ = _run(lambda: TorchFeedForward(device="cpu", **FF), path,
                   checkpoint_dir=str(tmp_path / "ck2"),
                   checkpoint_final_epoch=True)
    assert full is not None


# --- schedule_total_epochs against the reference ---


class JaxFF(JaxFeedForward):
    @staticmethod
    def get_knob_config():
        cfg = dict(JaxFeedForward.get_knob_config())
        cfg["max_epochs"] = JaxIntegerKnob(1, 6)
        cfg["batch_size"] = JaxFixedKnob(32)
        return cfg


class TorchFF(TorchFeedForward):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchFeedForward.get_knob_config())
        cfg["max_epochs"] = IntegerKnob(1, 6)
        cfg["batch_size"] = FixedKnob(32)
        return cfg


@pytest.fixture(scope="module")
def ff_set(tmp_path_factory):
    return make_synthetic_image_dataset(
        str(tmp_path_factory.mktemp("ffsched")), n_train=128, n_val=64,
        image_shape=(12, 12, 1), n_classes=4)


def _pair_train(tmp_path, ff_set, epochs, chain):
    """Both packages from the same start: (jax params, jax epoch
    records, port params, port epoch records, start)."""
    train = ff_set[0]
    start = _params(seed=5)
    knobs = dict(hidden_layer_count=2, hidden_layer_units=100,
                 learning_rate=3e-3)
    out = []
    for cls, lg, tag in ((JaxFF, jax_logger, "jax"),
                         (TorchFF, logger, "torch")):
        def make(n, cls=cls):
            k = cls.validate_knobs(dict(knobs, max_epochs=n))
            return cls(**k) if cls is JaxFF else cls(device="cpu", **k)

        recs = []
        prior = lg.current_sink()
        lg.set_sink(recs.append)
        try:
            if chain:
                d = str(tmp_path / f"chain-{tag}")
                m = make(1)
                m.train(train, shared_params=start, checkpoint_dir=d,
                        checkpoint_final_epoch=True,
                        schedule_total_epochs=6)
            m = make(epochs)
            m.train(train, shared_params=start, schedule_total_epochs=6,
                    **({"checkpoint_dir": d, "checkpoint_final_epoch": True}
                       if chain else {}))
        finally:
            lg.set_sink(prior)
        out += [m.dump_parameters(),
                [r["values"] for r in recs if r["type"] == "values"
                 and "epoch" in r.get("values", {})]]
    return (*out, start)


def _close_to_the_reference(jp, jrec, tp, trec, start):
    assert [r["epoch"] for r in jrec] == [r["epoch"] for r in trec]
    for a, b in zip(jrec, trec):
        assert abs(a["loss"] - b["loss"]) <= LOSS_ATOL
    for k in sorted(jp):
        if k.startswith("_"):
            continue
        a, b = np.asarray(jp[k]), tp[k]
        step = np.linalg.norm(a - start[k])
        if step == 0:
            np.testing.assert_array_equal(b, start[k])
            continue
        assert np.linalg.norm(b - a) <= UPDATE_RTOL * step, k


def test_a_6_epoch_horizon_matches_the_reference(tmp_path, ff_set):
    jp, jrec, tp, trec, start = _pair_train(tmp_path, ff_set, 2, False)
    assert [r["epoch"] for r in trec] == [0, 1]
    _close_to_the_reference(jp, jrec, tp, trec, start)
    # The horizon changes the run: the same 2 epochs on a 2-epoch
    # schedule end elsewhere.
    short = TorchFF(device="cpu", **TorchFF.validate_knobs(dict(
        hidden_layer_count=2, hidden_layer_units=100, learning_rate=3e-3,
        max_epochs=2)))
    short.train(ff_set[0], shared_params=start)
    assert any(not np.array_equal(short.dump_parameters()[k], tp[k])
               for k in tp if not k.startswith("_"))


def test_a_rung_chain_matches_the_reference_chain(tmp_path, ff_set):
    jp, jrec, tp, trec, start = _pair_train(tmp_path, ff_set, 3, True)
    # The resumed rung logs epochs 1 and 2 in both packages.
    assert [r["epoch"] for r in trec] == [0, 1, 2]
    _close_to_the_reference(jp, jrec, tp, trec, start)


# --- The runner's crash resume ---


class _Fixed:
    def __init__(self, knobs):
        self.knobs, self.n, self.forgotten = knobs, 0, 0

    def propose(self):
        self.n += 1
        return Proposal(trial_no=self.n, knobs=dict(self.knobs))

    def feedback(self, proposal, score):
        pass

    def forget(self, proposal):
        self.forgotten += 1


class FF3(TorchFeedForward):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchFeedForward.get_knob_config())
        cfg["max_epochs"] = FixedKnob(3)
        cfg["batch_size"] = FixedKnob(32)
        return cfg


def test_runner_crash_resume_and_tombstone(tmp_path, data, monkeypatch):
    monkeypatch.setenv("RAFIKI_TPU_CKPT", "1")
    train, val = data["small"]
    knobs = FF3.validate_knobs({"hidden_layer_count": 1,
                                "hidden_layer_units": 16,
                                "learning_rate": 3e-3})
    full = FF3(device="cpu", **knobs)
    full.train(train)
    want = full.dump_parameters()
    meta = MetaStore(":memory:")
    params = ParamStore(str(tmp_path / "p"))
    adv = _Fixed(knobs)
    runner = TrialRunner(FF3, adv, train, val, meta, params, "s1",
                         budget={"MODEL_TRIAL_COUNT": 1}, device="cpu")
    proposal = adv.propose()
    seen = []

    def dying(rec):
        seen.append(rec)
        if rec.get("type") == "values" \
                and rec.get("values", {}).get("epoch") == 2:
            raise _Crash("worker died")

    logger.set_sink(dying)
    try:
        row = runner.run_one(proposal)
    finally:
        logger.set_sink(None)
    assert row["status"] == "ERRORED" and adv.forgotten == 1
    root = os.path.join(params.params_dir, "ckpt")
    (digest,) = os.listdir(root)
    assert CheckpointManager(os.path.join(root, digest)).steps() == [0, 1]

    row = runner.run_one(proposal)
    assert row["status"] == "COMPLETED"
    logs = [r["record"] for r in meta.get_trial_logs(row["id"])]
    assert {"msg": "resumed from checkpoint epoch 1"} in _values(logs)
    assert _epochs(logs) == [2]
    got = params.load(row["params_id"])
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    # The spent directory was renamed to a tombstone and deleted.
    assert os.listdir(root) == []
    meta.close()
    params.close()
