"""Parameter layout bridges between the two packages.

Flat flax names (``dense_from_jax`` / ``dense_to_jax``): a reference
``JaxModel.dump_parameters()`` names each leaf by its flax path under
its collection, ``params/Dense_0/kernel`` or
``batch_stats/_DenseLayer_0/BatchNorm_0/mean``. The port's modules are
named as the flax modules, so the path maps to a ``state_dict`` key
with ``.`` for ``/``, and the leaf maps by its kind:

- a ``Dense`` kernel ``(in, out)`` is an ``nn.Linear`` ``weight``
  ``(out, in)``;
- a ``Conv`` kernel, HWIO ``(kh, kw, in / groups, out)``, is a
  ``weight`` OIHW ``(out, in / groups, kh, kw)``; a depthwise kernel
  ``(k, k, 1, C)`` (``feature_group_count=C``) becomes ``(C, 1, k, k)``
  for ``groups=C`` by the same transpose;
- a norm's ``scale`` is its ``weight``, and ``bias`` stays ``bias``;
- ``batch_stats``' ``mean`` and ``var`` are the buffers
  ``running_mean`` and ``running_var``.

The ENAS controller (``controller_from_jax`` / ``controller_to_jax``):
flax's ``LSTMCell`` keeps eight gate ``Dense`` layers, the input ones
(``ii``, ``if``, ``ig``, ``io``) without a bias and the hidden ones
(``hi``, ``hf``, ``hg``, ``ho``) with one; ``nn.LSTMCell`` stacks them
in the same (i, f, g, o) order as ``weight_ih`` and ``weight_hh``, with
the hidden biases as ``bias_hh`` and ``bias_ih`` zero. ``Embed_0``'s
``embedding`` is ``nn.Embedding``'s ``weight`` as it is; the heads are
``Dense`` layers.

Every round trip is exact: transposes and copies of float32 arrays.

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

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .base import Params

LINEARS = ("qkv", "proj", "w1", "w2")
NORMS = ("ln1", "ln2")


#: OIHW <-> HWIO.
_TO_OIHW = (3, 2, 0, 1)
_TO_HWIO = (2, 3, 1, 0)
_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}


def torch_name(key: str, ndim: int) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """A reference flat name of a leaf of ``ndim`` dims -> its
    ``state_dict`` key and the permutation from flax's layout to the
    port's (None: the same layout)."""
    coll, *path, leaf = key.split("/")
    name, perm = None, None
    if not path:
        pass
    elif coll == "params":
        if leaf == "kernel" and ndim == 2:
            name, perm = "weight", (1, 0)
        elif leaf == "kernel" and ndim == 4:
            name, perm = "weight", _TO_OIHW
        elif leaf in ("bias", "scale") and ndim == 1:
            name = "bias" if leaf == "bias" else "weight"
    elif coll == "batch_stats" and leaf in _STATS and ndim == 1:
        name = _STATS[leaf]
    if name is None:
        raise ValueError(f"no port layout for parameter {key!r} of "
                         f"{ndim} dims")
    return ".".join(path + [name]), perm


def jax_name(key: str, ndim: int) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """A ``state_dict`` key of a tensor of ``ndim`` dims -> its reference
    flat name and the permutation from the port's layout to flax's
    (None: the same layout)."""
    *path, name = key.split(".")
    coll, leaf, perm = "params", None, None
    if name == "weight" and ndim == 2:
        leaf, perm = "kernel", (1, 0)
    elif name == "weight" and ndim == 4:
        leaf, perm = "kernel", _TO_HWIO
    elif name in ("weight", "bias") and ndim == 1:
        leaf = "scale" if name == "weight" else "bias"
    elif name in _STATS_BACK and ndim == 1:
        coll, leaf = "batch_stats", _STATS_BACK[name]
    if leaf is None:
        raise ValueError(f"no reference layout for {key!r} of {ndim} dims")
    return "/".join([coll, *path, leaf]), perm


def dense_from_jax(params: Params) -> Dict[str, torch.Tensor]:
    """Reference flat ``params/...`` and ``batch_stats/...`` dict -> the
    port's ``state_dict`` (CPU, float32). ``_meta/...`` entries are
    skipped."""
    state: Dict[str, torch.Tensor] = {}
    for key, value in params.items():
        if key.startswith("_meta/"):
            continue
        a = np.asarray(value, dtype=np.float32)
        name, perm = torch_name(key, a.ndim)
        if perm is not None:
            a = a.transpose(perm)
        state[name] = torch.from_numpy(np.array(a, copy=True))
    return state


def dense_to_jax(state: Dict[str, torch.Tensor]) -> Params:
    """The port's ``state_dict`` -> the reference flat dict (host numpy,
    float32)."""
    out: Params = {}
    for key, t in state.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        name, perm = jax_name(key, a.ndim)
        if perm is not None:
            a = a.transpose(perm)
        out[name] = np.array(a, copy=True)
    return out


def dense_from_jax_tensors(flat: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """``dense_from_jax`` on tensors where they lie, with no copy but
    the permutations' views: what a serving graph builds its module's
    state from (int8 weights dequantised in the graph, flax layout)."""
    state = {}
    for key, t in flat.items():
        name, perm = torch_name(key, t.dim())
        state[name] = t.permute(perm) if perm is not None else t
    return state


_LSTM = "params/LSTMCell_0/"
_EMBED = "params/Embed_0/embedding"


def controller_from_jax(params: Params) -> Dict[str, torch.Tensor]:
    """The reference ENAS controller's flat ``params/...`` dict -> the
    port's controller ``state_dict`` (CPU, float32)."""

    def a(k: str) -> np.ndarray:
        return np.asarray(params[_LSTM + k], np.float32)

    def t(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(x, np.float32, copy=True))

    rest = {k: v for k, v in params.items()
            if not k.startswith(_LSTM) and k != _EMBED}
    state = dense_from_jax(rest)
    bias_hh = np.concatenate([a(f"h{g}/bias") for g in "ifgo"])
    state.update({
        "LSTMCell_0.weight_ih": t(np.concatenate(
            [a(f"i{g}/kernel").T for g in "ifgo"])),
        "LSTMCell_0.weight_hh": t(np.concatenate(
            [a(f"h{g}/kernel").T for g in "ifgo"])),
        "LSTMCell_0.bias_ih": t(np.zeros_like(bias_hh)),
        "LSTMCell_0.bias_hh": t(bias_hh),
        "Embed_0.weight": t(params[_EMBED]),
    })
    return state


def controller_to_jax(state: Dict[str, torch.Tensor]) -> Params:
    """The port's controller ``state_dict`` -> the reference's flat
    ``params/...`` dict (host numpy, float32). ``bias_ih`` must be
    zero: the reference has no input-gate bias."""

    def a(k: str) -> np.ndarray:
        return state[k].detach().to("cpu", torch.float32).numpy()

    if np.any(a("LSTMCell_0.bias_ih")):
        raise ValueError("the controller's bias_ih is not zero")
    out = dense_to_jax({k: v for k, v in state.items()
                        if not k.startswith(("LSTMCell_0.", "Embed_0."))})
    for prefix, mat in (("i", a("LSTMCell_0.weight_ih")),
                        ("h", a("LSTMCell_0.weight_hh"))):
        for g, block in zip("ifgo", np.split(mat, 4)):
            out[f"{_LSTM}{prefix}{g}/kernel"] = np.array(block.T, copy=True)
    for g, b in zip("ifgo", np.split(a("LSTMCell_0.bias_hh"), 4)):
        out[f"{_LSTM}h{g}/bias"] = np.array(b, copy=True)
    out[_EMBED] = np.array(a("Embed_0.weight"), copy=True)
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
