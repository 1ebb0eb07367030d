"""Accuracy parity on real data, for the port: the counterpart of the
reference's ``examples/scripts/accuracy_parity.py``, with the same rows,
knobs and bands on the port's classes.

The data needs no download: the UCI handwritten digits (1,797 real 8×8
scans) and the breast-cancer and wine tables ship inside scikit-learn,
and the hand-tagged English POS corpus (679 sentences) is in the
repository (``examples/datasets/english_pos``). The bands are the
reference's: the published accuracies of the same model families on
these sets, and for the taggers 2-3 points under the worst of three
split seeds the reference measured (BiLSTM 0.913-0.920, transformer
0.871-0.889).

Run:  python -m rafiki_torch.accuracy_parity [--fast] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and exits non-zero
when a model lands below its band. ``--fast`` runs the rows that take
under a minute (the sklearn models, the feed-forward net, the CNN and
the tabular MLPs). The digits and the tables need scikit-learn: where it
is missing, the run stops at the first row with the import's error,
which names it. The corpus rows need nothing but the repository;
``corpus_rows`` runs them alone (the card's machine has no sklearn, and
``chip_smoke.py`` calls it there).
"""

from __future__ import annotations

import tempfile
import time
from typing import Any, Dict, List, Optional

from .torchenv import DeviceLike

#: The taggers' rows on the bundled corpus: (class name, knobs, band).
CORPUS_ROWS = (
    ("TorchPosTagger",
     {"embed_dim": 64, "hidden": 128, "learning_rate": 1e-2,
      "batch_size": 32, "max_epochs": 20}, 0.89),
    ("TorchTransformerTagger",
     {"d_model": 128, "n_heads": 4, "n_layers": 2, "learning_rate": 3e-3,
      "batch_size": 32, "max_epochs": 30, "max_len": 64, "dropout": 0.1},
     0.84),
)


def record(results: List[Dict[str, Any]], model: str, dataset: str,
           acc: float, band: float, **extra: Any) -> Dict[str, Any]:
    row = dict(model=model, dataset=dataset, acc=acc, band=band,
               ok=acc >= band, **extra)
    results.append(row)
    print(f"{model:22s} {dataset:14s} acc={acc:.4f} "
          f"(expected >= {band:.2f}) {'OK' if row['ok'] else 'BELOW BAND'}",
          flush=True)
    return row


def run_model(results, model_class, knobs, train, val, name, band,
              device: DeviceLike) -> Dict[str, Any]:
    """One model trained on ``train`` and scored on ``val``."""
    t0 = time.perf_counter()
    model = model_class(device=device, **model_class.validate_knobs(knobs))
    model.train(train)
    acc = float(model.evaluate(val))
    model.destroy()
    return record(results, model_class.__name__, name, acc, band,
                  seconds=time.perf_counter() - t0)


def run_enas_search(results, train, val, band: float,
                    device: DeviceLike) -> Dict[str, Any]:
    """ENAS on the digits through the port's advisor and ``TrialRunner``:
    8 weight-shared search trials, then the final retraining of the best
    architecture from scratch."""
    from .advisor import make_advisor
    from .constants import BudgetOption
    from .models import TorchEnas
    from .store import MetaStore, ParamStore
    from .worker.runner import TrialRunner

    total = 9
    with tempfile.TemporaryDirectory() as tmp:
        advisor = make_advisor(TorchEnas.get_knob_config(), seed=0,
                               total_trials=total, device=device)
        runner = TrialRunner(
            TorchEnas, advisor, train, val, MetaStore(":memory:"),
            ParamStore(tmp + "/params"), sub_train_job_id="parity-enas",
            budget={BudgetOption.MODEL_TRIAL_COUNT: total}, device=device)
        best = 0.0
        for _ in range(total):
            trial = runner.run_one()
            if trial.get("score") is not None:
                best = max(best, float(trial["score"]))
    return record(results, "TorchEnas(search)", "digits", best, band)


def corpus_rows(out_dir: str, device: DeviceLike = None,
                results: Optional[List[Dict[str, Any]]] = None,
                seed: int = 0) -> List[Dict[str, Any]]:
    """Both taggers trained on the bundled corpus's train split and
    scored on its val split (``seed`` picks the split), one row each."""
    from . import models
    from .datasets import prepare_bundled_pos_corpus

    results = [] if results is None else results
    train, val = prepare_bundled_pos_corpus(out_dir, seed=seed)
    return [run_model(results, getattr(models, cls), knobs, train, val,
                      "english_pos", band, device)
            for cls, knobs, band in CORPUS_ROWS]


def main(fast: bool = False, device: DeviceLike = None) -> int:
    from .datasets import prepare_sklearn_digits, prepare_sklearn_tabular
    from .models import (SkDt, SkSvm, TorchCnn, TorchDenseNet,
                         TorchFeedForward, TorchTabMlpClf, TorchViT)

    results: List[Dict[str, Any]] = []
    with tempfile.TemporaryDirectory() as tmp:
        train, val = prepare_sklearn_digits(tmp + "/digits")
        for cls, knobs, band in (
                (SkSvm, {"C": 10.0, "kernel": "rbf", "max_iter": 1000},
                 0.95),
                (SkDt, {"max_depth": 12, "criterion": "gini",
                        "min_samples_leaf": 1}, 0.75),
                (TorchFeedForward,
                 {"hidden_layer_count": 2, "hidden_layer_units": 128,
                  "learning_rate": 3e-3, "batch_size": 64,
                  "max_epochs": 5}, 0.90),
                (TorchCnn,
                 {"width_16ths": 16, "learning_rate": 3e-3,
                  "batch_size": 64, "weight_decay": 1e-4,
                  "max_epochs": 12, "early_stop_epochs": 5}, 0.90)):
            run_model(results, cls, knobs, train, val, "digits", band,
                      device)
        if not fast:
            run_model(results, TorchViT,
                      {"depth": 4, "learning_rate": 1e-3, "batch_size": 64,
                       "weight_decay": 1e-4, "max_epochs": 25},
                      train, val, "digits", 0.90, device)
            # DenseNet-BC at its tiny preset: the 8×8 digits cannot feed
            # 121 layers, but the family (dense blocks, BatchNorm, the
            # SGD-cosine recipe) is the one the 121 preset scales up.
            run_model(results, TorchDenseNet,
                      {"arch": "densenet_tiny", "growth_rate": 12,
                       "learning_rate": 0.05, "batch_size": 64,
                       "weight_decay": 1e-4, "max_epochs": 30,
                       "early_stop_epochs": 5, "quick_train": False},
                      train, val, "digits", 0.90, device)
            # The searched architecture must land in the hand-designed
            # CNN's band: the search must not lose accuracy.
            run_enas_search(results, train, val, 0.90, device)
            corpus_rows(tmp + "/pos", device, results)

        for dataset, band in (("breast_cancer", 0.90), ("wine", 0.90)):
            train, val = prepare_sklearn_tabular(dataset, f"{tmp}/{dataset}")
            run_model(results, TorchTabMlpClf,
                      {"hidden": 64, "depth": 2, "learning_rate": 3e-3,
                       "batch_size": 32, "max_epochs": 40},
                      train, val, dataset, band, device)

    failed = [r for r in results if not r["ok"]]
    print(f"\nACCURACY PARITY {'FAILED' if failed else 'OK'} "
          f"({len(results) - len(failed)}/{len(results)} in band)")
    return 1 if failed else 0


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(prog="python -m rafiki_torch.accuracy_parity")
    parser.add_argument("--fast", action="store_true",
                        help="the sub-minute rows only")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the card)")
    args = parser.parse_args()
    raise SystemExit(main(fast=args.fast, device=args.device))
