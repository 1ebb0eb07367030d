"""Stacked ensembles: a bin of congruent members served as one dispatch.

The counterpart of the reference's ``stack_congruence``,
``stack_members`` and ``StackedMembers`` (``jax_model.py:1423-1745``),
re-exported by ``torch_model``. The best trials of one search usually
share a model family and differ only in weights; served member by
member, a burst costs one dispatch a member. Here the members' tensors
stack along a leading model axis once, at load time
(``torch.func.stack_module_state``'s layout: one tensor a parameter or
buffer, its first dim the member), their extra inputs with them (the
FeedForward masks, the ENAS architecture), and one forward runs them
all: ``functional_call`` of member 0's module under ``torch.func.vmap``
over the model axis, the batch shared. On the card each ``(bucket,
is_u8, quant)`` is one CUDA graph (``PredictRunner``), all of a group's
graphs in one memory pool.

``update_member`` (the promote path's restack) copies the incoming
member's tensors into its slice of the stacked storage in place, so the
captured graphs read the new weights with no recapture: the counterpart
of the reference's runners reading ``self._vars_dev`` at each call.
Rebinding a stacked tensor instead would leave every graph reading the
old one.

Congruence (``stack_congruence``) gives the reference's verdicts on the
same member sets: PyTorch modules do not compare equal as flax's
dataclasses do, so each model states its module's static configuration
(``TorchModel.module_config``), and the parameter trees compare in the
reference's flat layout.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call, vmap

from .bridge import jax_name
from .torch_model import (PredictRunners, TorchModel, dequantized_state,
                          host_input, normalised, padded_to_bucket,
                          probabilities, staged_chunk)

_log = logging.getLogger(__name__)


def _flat_layout(model: TorchModel) -> Dict[str, Any]:
    """The member's parameters as the reference's flat names -> (shape,
    dtype) in the reference's layout."""
    out = {}
    for key, t in model._net.state_dict().items():
        name, perm = jax_name(key, t.dim())
        shape = tuple(t.shape)
        if perm is not None:
            shape = tuple(shape[p] for p in perm)
        out[name] = (shape, str(t.dtype).replace("torch.", ""))
    return out


def stack_congruence(models: List[Any]) -> Optional[str]:
    """None when ``models`` can serve as one stacked forward, else the
    reason: the same concrete ``TorchModel`` class, equal
    ``stack_signature``s, one serving quant mode, parameter trees of the
    same names, shapes and dtypes, and the same extra inputs."""
    if len(models) < 2:
        return "fewer than two members"
    for i, m in enumerate(models):
        if not isinstance(m, TorchModel):
            return (f"member {i} ({type(m).__name__}) is not a "
                    f"TorchModel (sk-style/sequence members serve "
                    f"per-member)")
        if not getattr(m, "stack_compatible", False):
            return (f"member {i} ({type(m).__name__}) opts out of "
                    f"stacking")
        if m._net is None:
            return f"member {i} has no loaded parameters"
    m0 = models[0]
    sig0 = m0.stack_signature()
    flat0 = _flat_layout(m0)
    extra0 = m0.extra_apply_inputs()
    for i, m in enumerate(models[1:], start=1):
        if type(m) is not type(m0):
            return (f"member {i} is {type(m).__name__}, member 0 is "
                    f"{type(m0).__name__}")
        if m.stack_signature() != sig0:
            return f"member {i} has a different stack signature"
        if m._quant_mode != m0._quant_mode:
            return f"member {i} has a different serving quant mode"
        flat = _flat_layout(m)
        if set(flat) != set(flat0):
            return f"member {i} has a different parameter tree"
        for k, (shape0, dtype0) in flat0.items():
            shape, dtype = flat[k]
            if shape != shape0 or dtype != dtype0:
                return (f"member {i} leaf {k}: {shape}/{dtype} != "
                        f"{shape0}/{dtype0}")
        extra = m.extra_apply_inputs()
        if set(extra) != set(extra0):
            return f"member {i} has different extra apply inputs"
        for k, v0 in extra0.items():
            if tuple(np.shape(extra[k])) != tuple(np.shape(v0)):
                return f"member {i} extra input {k} shape differs"
    return None


def stack_members(models: List[Any]) -> Optional["StackedMembers"]:
    """The stacked group of congruent members, or None (the probe's
    reason logged) when the bin must serve member by member."""
    reason = stack_congruence(models)
    if reason is not None:
        _log.info("ensemble not stackable (%s); serving per-member",
                  reason)
        return None
    return StackedMembers(models)


class StackedMembers:
    """N congruent members as one stacked copy of their tensors on the
    device and one vmapped forward a ``(bucket, is_u8, quant)``.

    The member list stays for per-member fallback and restacks. Under
    int8 serving the stacked copy is of the members' int8 weights,
    scales and f32 leaves instead. ``valid`` is the member-validity
    mask: a member whose restack failed half way is left out of the
    votes until a later restack lands."""

    def __init__(self, models: List[Any]):
        self.models = list(models)
        m0 = models[0]
        self.device = m0.device
        self.valid: List[bool] = [True] * len(models)
        self._quant = m0._quant_mode
        self._runners = PredictRunners(self.device)
        with torch.no_grad():
            if self._quant:
                hosts = [m._quant_host_arrays() for m in models]
                self._vars: Dict[str, Any] = {
                    part: {k: self._put(np.stack([h[j][k] for h in hosts]))
                           for k in hosts[0][j]}
                    for j, part in enumerate(("q", "s", "f"))}
                for m in models:
                    # The per-member host copies are whole extra weight
                    # copies; the stacked arrays now serve.
                    m._quant_host = None
            else:
                states = [m._net.state_dict() for m in models]
                self._vars = {k: torch.stack([s[k] for s in states])
                              for k in states[0]}
            extras = [m.extra_apply_inputs() for m in models]
            self._extra = {k: self._put(np.stack([np.asarray(e[k])
                                                  for e in extras]))
                           for k in extras[0]}
        # Member 0's module, its tensors on the meta device: every call
        # gives it the stacked tensors (``functional_call``), so the
        # members' own modules are never touched.
        self._module = copy.deepcopy(m0._net).to("meta")

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @property
    def n_members(self) -> int:
        return len(self.models)

    @property
    def n_valid(self) -> int:
        return sum(1 for v in self.valid if v)

    def predict_bucket(self, n: int, dtype: Any = None) -> Optional[int]:
        """The members' bucket ladder (congruent members share it)."""
        return self.models[0].predict_bucket(n, dtype)

    # --- Dispatch ---

    def staged_submit(self, buf: np.ndarray, n: int):
        """One dispatch straight from a staging buffer whose leading
        dim is exactly the bucket (rows ``[n:]`` padding): ``((M,
        bucket, n_classes) device probabilities, n)``."""
        buf = staged_chunk(buf, n, self.models[0]._meta["image_shape"],
                           self.predict_bucket(n, buf.dtype))
        return self._dispatch(buf), n

    def submit(self, queries: List[Any]):
        """Queries as objects: stacked on the host once, then one
        dispatch a ``max_predict_batch`` chunk. Returns ``[(device
        probabilities, count)]`` for ``member_finishers``."""
        m0 = self.models[0]
        imgs = m0._stack_queries(queries)
        step = m0.max_predict_batch
        handles = []
        for start in range(0, imgs.shape[0], step):
            chunk = imgs[start:start + step]
            handles.append((self._dispatch(padded_to_bucket(
                chunk, m0.mesh.shape["dp"])),
                            chunk.shape[0]))
        return handles

    def _dispatch(self, chunk: np.ndarray) -> torch.Tensor:
        x, is_u8 = host_input(chunk)
        return self._runners.run((chunk.shape[0], is_u8, self._quant), x,
                                 lambda: self._forward(is_u8))

    @property
    def captures(self) -> int:
        """CUDA graphs this group captured."""
        return self._runners.captures

    def _forward(self, is_u8: bool) -> Callable[[torch.Tensor],
                                                torch.Tensor]:
        """Input rows -> ``(M, rows, n_classes)`` f32 probabilities: the
        member forward vmapped over the stacked tensors and extras, the
        rows shared. It reads ``self._vars`` at each call."""
        module = self._module
        quantized_apply = self.models[0].quantized_apply

        if self._quant:
            def member(packed, extra, x):
                q, s, f = packed["q"], packed["s"], packed["f"]
                xf = normalised(x, is_u8)
                logits = quantized_apply(q, s, f, xf, extra)
                if logits is None:
                    logits = functional_call(
                        module, dequantized_state(q, s, f), (xf,), extra)
                return probabilities(logits)
        else:
            def member(state, extra, x):
                return probabilities(functional_call(
                    module, state, (normalised(x, is_u8),), extra))

        batched = vmap(member, in_dims=(0, 0, None))
        return lambda x: batched(self._vars, self._extra, x)

    def member_finishers(self, handles) -> List[Callable[[], List[Any]]]:
        """One finisher a valid member over one shared readback: the
        first to run copies the handles' results to the host, the rest
        slice them. Masked members are left out."""
        if not isinstance(handles, list):
            handles = [handles]
        fetched: Dict[int, np.ndarray] = {}

        def fetch(j: int) -> np.ndarray:
            out = fetched.get(j)
            if out is None:
                out = handles[j][0].cpu().numpy()  # (M, bucket, C)
                fetched[j] = out
            return out

        fins = []
        for i, ok in enumerate(self.valid):
            if not ok:
                continue

            def fin(i=i) -> List[Any]:
                rows: List[Any] = []
                for j, (_, count) in enumerate(handles):
                    rows.extend(p.tolist() for p in fetch(j)[i, :count])
                return rows

            fins.append(fin)
        return fins

    def warmup(self) -> None:
        """Build (and on the card capture) the smallest bucket's float32
        and uint8 runners and run each once."""
        shape = tuple(self.models[0]._meta["image_shape"])
        bucket = self.predict_bucket(1, np.float32)
        for dtype in (np.float32, np.uint8):
            self._dispatch(np.zeros((bucket, *shape), dtype)).cpu()

    # --- The promote path's restack ---

    def update_member(self, index: int, model: Any) -> None:
        """Put ``model``'s tensors (and int8 scales and extras) in member
        ``index``'s slice of the stacked storage, in place: the other
        members stay where they are and every captured graph stays
        valid. An incongruent model raises before any state changes; a
        failure half way masks the member out of the votes rather than
        serve half-swapped weights."""
        if not 0 <= index < len(self.models):
            raise IndexError(f"no stacked member {index}")
        ref = self.models[1] if index == 0 else self.models[0]
        reason = stack_congruence([ref, model])
        if reason is not None:
            raise ValueError(f"incoming member is not congruent with "
                             f"the stacked group: {reason}")
        # Whatever may fail before any stacked tensor moves.
        if self._quant:
            q, s, f, _ = model._quant_host_arrays()
            new: Dict[str, Any] = {"q": q, "s": s, "f": f}
            pairs = [(self._vars[p][k], new[p][k])
                     for p in ("q", "s", "f") for k in self._vars[p]]
        else:
            state = model._net.state_dict()
            pairs = [(st, state[k]) for k, st in self._vars.items()]
        extra = model.extra_apply_inputs()
        pairs += [(st, extra[k]) for k, st in self._extra.items()]
        try:
            with torch.no_grad():
                for st, value in pairs:
                    st[index].copy_(torch.as_tensor(value))
        except Exception:
            self.valid[index] = False
            raise
        if self._quant:
            model._quant_host = None
        self.models[index] = model
        self.valid[index] = True

    def destroy(self) -> None:
        self._runners.clear()
        self._vars = {}
        self._extra = {}
