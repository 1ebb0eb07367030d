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
- an ``Embed``'s ``embedding`` is ``nn.Embedding``'s ``weight`` as it
  is;
- a module's own parameter (ViT's ``params/cls`` and
  ``params/pos_embed``) keeps its name and layout, and so do a MoE
  block's router and expert stacks (``moe_gate`` (D, E), ``expert_w1``
  (E, D, F), ``expert_b1`` (E, F), ``expert_w2`` (E, F, D),
  ``expert_b2`` (E, D)), which the port holds in flax's layout;
- ``batch_stats``' ``mean`` and ``var`` are the buffers
  ``running_mean`` and ``running_var``;
- an LSTM cell (``OptimizedLSTMCell_0``, the ENAS controller's
  ``LSTMCell_0``): flax keeps eight gate ``Dense`` layers, the input
  ones (``ii``, ``if``, ``ig``, ``io``) without a bias and the hidden
  ones (``hi``, ``hf``, ``hg``, ``ho``) with one; ``nn.LSTMCell``
  stacks them in the same (i, f, g, o) order as ``weight_ih`` and
  ``weight_hh``, with the hidden biases as ``bias_hh`` and ``bias_ih``
  zero.

A ``_meta/...`` entry is the model's own and does not cross.
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
#: A MoE block's own parameters, kept in flax's layout.
MOE_LEAVES = frozenset(("moe_gate", "expert_w1", "expert_b1", "expert_w2",
                        "expert_b2"))


#: OIHW <-> HWIO.
_TO_OIHW = (3, 2, 0, 1)
_TO_HWIO = (2, 3, 1, 0)
_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}
#: flax's LSTM gate layers (``OptimizedLSTMCell``, ``LSTMCell``), in
#: torch's (i, f, g, o) order of ``weight_ih``/``weight_hh`` rows.
_GATES = "ifgo"
_GATE_LAYERS = frozenset([f"i{g}" for g in _GATES]
                         + [f"h{g}" for g in _GATES])
_LSTM_NAMES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def torch_name(key: str, ndim: int) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """A reference flat name of a leaf of ``ndim`` dims -> its
    ``state_dict`` key and the permutation from flax's layout to the
    port's (None: the same layout)."""
    coll, *path, leaf = key.split("/")
    name, perm = None, None
    if coll == "params" and not path:
        name = leaf  # a module's own parameter (ViT's cls, pos_embed)
    elif not path:
        pass
    elif coll == "params":
        if leaf in MOE_LEAVES:
            name = leaf
        elif leaf == "kernel" and ndim == 2:
            name, perm = "weight", (1, 0)
        elif leaf == "kernel" and ndim == 4:
            name, perm = "weight", _TO_OIHW
        elif leaf == "embedding" and ndim == 2:
            name = "weight"
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
    if not path or name in MOE_LEAVES:
        leaf = name
    elif name == "weight" and ndim == 2 and path[-1].startswith("Embed"):
        leaf = "embedding"
    elif name == "weight" and ndim == 2:
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


def _is_gate(key: str) -> bool:
    parts = key.split("/")
    return len(parts) >= 4 and parts[-2] in _GATE_LAYERS


def _lstm_from_jax(params: Params) -> Dict[str, torch.Tensor]:
    """Each flax LSTM cell's eight gate ``Dense`` layers -> an
    ``nn.LSTMCell``'s tensors: the input kernels (``ii`` … ``io``, no
    bias) stacked as ``weight_ih``, the hidden ones (``hi`` … ``ho``)
    as ``weight_hh``, their biases as ``bias_hh``, ``bias_ih`` zero."""
    cells = sorted({k.rsplit("/", 2)[0] for k in params if _is_gate(k)})
    state = {}
    for cell in cells:
        def a(k: str) -> np.ndarray:
            return np.asarray(params[f"{cell}/{k}"], np.float32)

        name = ".".join(cell.split("/")[1:])
        bias_hh = np.concatenate([a(f"h{g}/bias") for g in _GATES])
        for part, mat in (
                ("weight_ih", [a(f"i{g}/kernel").T for g in _GATES]),
                ("weight_hh", [a(f"h{g}/kernel").T for g in _GATES])):
            state[f"{name}.{part}"] = np.concatenate(mat)
        state[f"{name}.bias_ih"] = np.zeros_like(bias_hh)
        state[f"{name}.bias_hh"] = bias_hh
    return {k: torch.from_numpy(np.array(v, np.float32, copy=True))
            for k, v in state.items()}


def dense_from_jax(params: Params) -> Dict[str, torch.Tensor]:
    """Reference flat ``params/...`` and ``batch_stats/...`` dict -> the
    port's ``state_dict`` (CPU, float32). ``_meta/...`` entries are
    skipped; LSTM cells map as ``_lstm_from_jax`` says."""
    state = _lstm_from_jax(params)
    for key, value in params.items():
        if key.startswith("_meta/") or _is_gate(key):
            continue
        a = np.asarray(value, dtype=np.float32)
        name, perm = torch_name(key, a.ndim)
        if perm is not None:
            a = a.transpose(perm)
        state[name] = torch.from_numpy(np.array(a, copy=True))
    return state


def dense_to_jax(state: Dict[str, torch.Tensor]) -> Params:
    """The port's ``state_dict`` -> the reference flat dict (host numpy,
    float32): ``dense_to_jax_tensors``, read back in one packed pull."""
    from ..parallel.transfer import device_get_tree

    return device_get_tree(dense_to_jax_tensors(
        {k: t.detach().float() for k, t in state.items()}))


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


def _lstm_to_jax_tensors(state: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The inverse of ``_lstm_from_jax``, on tensors where they lie:
    views of the stacked gate matrices, transposed, and of the hidden
    biases; ``bias_ih`` must be zero (the reference has no input-gate
    bias)."""
    out: Dict[str, torch.Tensor] = {}
    for key in state:
        if not key.endswith(".weight_ih"):
            continue
        name = key[:-len(".weight_ih")]
        cell = "params/" + name.replace(".", "/")
        if bool(state[f"{name}.bias_ih"].any()):
            raise ValueError(f"{name}'s bias_ih is not zero")
        for prefix in ("i", "h"):
            mat = state[f"{name}.weight_{prefix}h"]
            for g, block in zip(_GATES, mat.chunk(4)):
                out[f"{cell}/{prefix}{g}/kernel"] = block.T
        for g, b in zip(_GATES, state[f"{name}.bias_hh"].chunk(4)):
            out[f"{cell}/h{g}/bias"] = b
    return out


def dense_to_jax_tensors(state: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The inverse of ``dense_from_jax_tensors``: the port's
    ``state_dict`` in the reference's flat names and layouts, on the
    tensors' own devices, with no copy but the permutations' views
    (``dense_to_jax`` without the host pull). A caller that keeps the
    result past a write to the module copies first
    (``TorchModel.dump_parameters``)."""
    out = _lstm_to_jax_tensors(state)
    for key, t in state.items():
        if key.rsplit(".", 1)[-1] in _LSTM_NAMES:
            continue
        name, perm = jax_name(key, t.dim())
        out[name] = t.permute(perm) if perm is not None else t
    return out


def dense_state(params: Params) -> Dict[str, torch.Tensor]:
    """A flat reference dict whose leaves are host arrays, tensors, or
    both -> the port's ``state_dict``: host leaves through
    ``dense_from_jax``, tensor leaves by ``dense_from_jax_tensors`` as
    float32 views where they lie (an LSTM cell's gate tensors go
    through the host). ``load_state_dict`` copies from the result, so
    the module never shares a tensor leaf's storage."""
    tensors = {k: v for k, v in params.items()
               if isinstance(v, torch.Tensor) and not k.startswith("_meta/")
               and not _is_gate(k)}
    host = {k: v for k, v in params.items() if k not in tensors}
    if any(isinstance(v, torch.Tensor) for v in host.values()):
        from ..parallel.transfer import device_get_tree
        host = device_get_tree(host)
    state = dense_from_jax(host)
    state.update(dense_from_jax_tensors(
        {k: v.detach().float() for k, v in tensors.items()}))
    return state


def overlay_params(module: torch.nn.Module, params: Params) -> int:
    """Warm start (the reference's ``_merge_shared``): load into
    ``module`` the leaves of the flat ``params`` whose names and shapes
    match its own; returns how many it took. Leaves may be host arrays
    or tensors (a pending save's in-memory tree): each is copied into
    the module's own tensors, never shared."""
    own = dense_to_jax_tensors(module.state_dict())
    take = {k: v for k, v in params.items()
            if not k.startswith("_") and k in own
            and tuple(own[k].shape) == tuple(np.shape(v))}
    if take:
        module.load_state_dict(dense_state(take), strict=False)
    return len(take)


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
