"""Parameter layout bridge between the two packages' language models.

The reference ``JaxTransformerLM.dump_parameters()`` gives a flat dict:
``embed`` (V, d), ``lnf`` (d,), and layer-stacked ``layers/qkv``
(L, d, 3d), ``layers/proj`` (L, d, d), ``layers/w1`` (L, d, 4d),
``layers/w2`` (L, 4d, d), ``layers/ln1`` and ``layers/ln2`` (L, d), with
dense kernels laid out ``(in, out)``. The port's module keeps one
``nn.Linear`` per projection and layer, whose weight is ``(out, in)``.

``lm_from_jax`` maps the first to a ``state_dict`` of the second and
``lm_to_jax`` maps back; the round trip is exact (transposes and copies
of float32 arrays only).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import Params

LINEARS = ("qkv", "proj", "w1", "w2")
NORMS = ("ln1", "ln2")


def n_layers_of(params: Params) -> int:
    return int(np.asarray(params["layers/qkv"]).shape[0])


def lm_from_jax(params: Params) -> Dict[str, torch.Tensor]:
    """Reference flat param dict -> the port's ``state_dict`` (CPU,
    float32)."""

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    state = {"embed": t(params["embed"]), "lnf": t(params["lnf"])}
    for i in range(n_layers_of(params)):
        for name in LINEARS:
            state[f"blocks.{i}.{name}.weight"] = t(
                np.asarray(params[f"layers/{name}"])[i].T)
        for name in NORMS:
            state[f"blocks.{i}.{name}"] = t(
                np.asarray(params[f"layers/{name}"])[i])
    return state


def lm_to_jax(state: Dict[str, torch.Tensor]) -> Params:
    """The port's ``state_dict`` -> the reference flat param dict (host
    numpy, float32)."""

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().to("cpu", torch.float32).numpy()

    n = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("blocks."))
    out: Params = {"embed": a(state["embed"]).copy(),
                   "lnf": a(state["lnf"]).copy()}
    for name in LINEARS:
        out[f"layers/{name}"] = np.stack(
            [a(state[f"blocks.{i}.{name}.weight"]).T for i in range(n)])
    for name in NORMS:
        out[f"layers/{name}"] = np.stack(
            [a(state[f"blocks.{i}.{name}"]) for i in range(n)])
    return out
