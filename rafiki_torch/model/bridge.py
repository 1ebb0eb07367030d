"""Parameter layout bridges between the two packages.

Flat flax names (``dense_from_jax`` / ``dense_to_jax``): a reference
``JaxModel.dump_parameters()`` names each leaf by its flax path,
``params/Dense_0/kernel``. A flax ``Dense`` kernel is ``(in, out)``; the
port's ``nn.Linear`` of the same path (``Dense_0``) holds it as
``weight`` ``(out, in)``, and ``…/bias`` maps to ``bias`` as it is. The
round trip is exact. Convolution kernels (HWIO) wait for the CNN slice.

The language model (``lm_from_jax`` / ``lm_to_jax``): the reference ``JaxTransformerLM.dump_parameters()`` gives a flat dict:
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


def dense_from_jax(params: Params) -> Dict[str, torch.Tensor]:
    """Reference flat ``params/...`` dict -> the port's ``state_dict``
    (CPU, float32). ``_meta/...`` entries are skipped."""
    state: Dict[str, torch.Tensor] = {}
    for key, value in params.items():
        if key.startswith("_meta/"):
            continue
        coll, *path, leaf = key.split("/")
        a = np.asarray(value, dtype=np.float32)
        if coll != "params" or not path:
            raise ValueError(f"no port layout for parameter {key!r}")
        if leaf == "kernel" and a.ndim == 2:
            name, a = "weight", a.T
        elif leaf == "bias" and a.ndim == 1:
            name = "bias"
        else:
            raise ValueError(f"no port layout for parameter {key!r} of "
                             f"shape {a.shape}")
        state[".".join(path + [name])] = torch.from_numpy(
            np.array(a, copy=True))
    return state


def dense_to_jax(state: Dict[str, torch.Tensor]) -> Params:
    """The port's ``state_dict`` -> the reference flat dict (host numpy,
    float32)."""
    out: Params = {}
    for key, t in state.items():
        *path, name = key.split(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if name == "weight" and a.ndim == 2:
            leaf, a = "kernel", a.T
        elif name == "bias" and a.ndim == 1:
            leaf = "bias"
        else:
            raise ValueError(f"no reference layout for {key!r} of shape "
                             f"{a.shape}")
        out["/".join(["params", *path, leaf])] = np.array(a, copy=True)
    return out


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
