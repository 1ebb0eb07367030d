"""Predictor core of the port: how one query's per-worker predictions
combine. The counterpart of ``ensemble_predictions`` in the reference's
``predictor/predictor.py``; the bus scatter-gather is not ported yet."""

from __future__ import annotations

from collections import Counter
from typing import Any, List, Optional

import numpy as np


def ensemble_predictions(worker_predictions: List[Any],
                         weights: Optional[List[int]] = None) -> Any:
    """Combine one query's per-worker predictions.

    Numeric predictions (class probabilities, LM scores) → weighted
    elementwise mean. Non-numeric predictions → majority vote (one vote
    per worker, ``repr`` as the equality key), ties broken by arrival
    order. Error replies are skipped; ``__members__`` replies vote once
    per member.
    """
    pairs = []
    for i, p in enumerate(worker_predictions):
        if isinstance(p, dict) and "error" in p:
            continue
        if isinstance(p, dict) and "__members__" in p:
            pairs.extend((m, 1) for m in p["__members__"])
            continue
        pairs.append((p, weights[i] if weights else 1))
    if not pairs:
        return None
    preds = [p for p, _ in pairs]
    try:
        arr = np.asarray(preds, dtype=np.float64)
        if not np.isnan(arr).any():
            w = np.asarray([w for _, w in pairs], dtype=np.float64)
            return np.average(arr, axis=0, weights=w).tolist()
    except (ValueError, TypeError):
        pass
    counts: Counter = Counter()
    for p, w in pairs:
        counts[repr(p)] += int(w)
    winner = counts.most_common(1)[0][0]
    return next(p for p, _ in pairs if repr(p) == winner)
