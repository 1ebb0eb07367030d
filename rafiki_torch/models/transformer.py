"""The transformer zoo's shared blocks and ``TorchTransformerTagger``.

The counterpart of the reference's ``models/transformer.py``:

- ``_EncoderBlock`` (ref :61-127): pre-LN, a bias-free QKV projection
  and output projection, the attention injected by the caller
  (``ops.default_attention``: K1 on the card, with K2 and K3 for the
  gradient; the blockwise formulation on the CPU), then a biased 4×
  FFN with flax's tanh ``gelu``. LayerNorms in f32 (eps 1e-6), the
  projections in ``layers.COMPUTE`` (bf16) on f32 parameters. With
  ``moe_experts`` above 0 the FFN is a Switch-routed expert FFN
  (``ops.switch_moe``; ``moe_gate`` and the expert stacks
  ``expert_w1``/``b1``/``w2``/``b2`` in flax's layout), whose
  load-balance loss the block appends to the caller's ``losses``
  (flax's ``sow("losses")``).
- ``quantized_encoder_block`` (ref :129-185): the same block in f32 on
  ``dynamic_int8_matmul``, for int8 serving; None for a MoE block.
- ``_TransformerTagger`` and ``TorchTransformerTagger`` (ref
  :188-758): an ``Embed`` in ``layers.COMPUTE`` (bf16) plus the
  sinusoidal table, the blocks
  with ``kv_mask = ids != PAD_ID``, an f32 LayerNorm and an f32 head.
  Training is ``optax.adamw`` (weight decay 1e-3) under the warm-up
  cosine from ``lr·0.1`` to ``lr`` over ``total // 10`` steps and down
  to ``lr·0.02`` (``scheduled_adamw``), on the corpus taggers' shared
  loop (``pos_tagger._CorpusTagger``), plus 0.01 times the MoE blocks'
  load-balance loss. Dropout draws come from ``utils.hashing.mix32`` of
  (seed, step, layer, each element's index in the whole batch's
  tensor), not from ``jax.random``, so a captured step would draw anew
  at each replay, and every parallel mode draws the single-device mask.

The parallel modes (ref :279-501) run on the tagger's ``mesh``, built
from the devices of the group bound to the thread
(``ChipGroup.current()``; a worker binds its own), or of the model's
device alone when none is bound, so a single-device caller is
unchanged. ``sequence_parallel`` shards the sequence (the ring or
Ulysses schedule, ``sp_schedule``); ``moe_experts`` with
``expert_parallel`` slices the expert stacks over ``ep``;
``pipeline_parallel`` runs the blocks as a GPipe pipeline
(``ops.pipeline_apply``) and composes with both; the rest of the mesh is
data-parallel. One controller runs every rank: parameters stay one
leaf each on the model's device, placed per rank by
``parallel.mesh.shard_variables`` (copies autograd carries back), and
the logits are gathered there for the loss, the mean over the whole
batch's real tokens. Routing follows the reference's grouping: over
the whole batch's flattened tokens outside the pipeline, over each
rank's microbatch inside it.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..model import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from ..model.dataset import PAD_ID
from ..model.optim import scheduled_adamw, warmup_cosine_decay_schedule
from ..ops.attention import (default_attention, ring_attention,
                             ulysses_attention)
from ..ops.moe import switch_moe
from ..ops.pipeline import pipeline_apply
from ..parallel import dist
from ..parallel.data import gather_ranks, group_mesh
from ..parallel.mesh import Mesh, shard_variables
from ..utils.hashing import M32, mix32
from . import layers
from .layers import Dense, Embed, LayerNorm, lecun_normal_
from .pos_tagger import _CorpusTagger

Attention = Callable[..., torch.Tensor]


def _sinusoidal(max_len: int, dim: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def hashed_dropout(x: torch.Tensor, rate: float, seed: int,
                   step: torch.Tensor, salt: int,
                   at: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """flax's ``Dropout``, ``where(keep, x / (1 − rate), 0)``, with
    ``keep`` drawn from ``mix32`` of (``seed``, the device step
    ``step``, ``salt``, each element's position): no generator state is
    read, so eager steps and graph replays draw alike.

    ``at`` = (row, position, length) says that the (b, t, F) ``x`` is
    the block at that row and position of a (rows, length, F) tensor: an
    element's position is then its flat index in that tensor, so a
    shard of a batch draws the whole batch's mask."""
    if rate <= 0.0:
        return x
    h = mix32(mix32(torch.full_like(step, seed & M32)) ^ (step & M32))
    h = mix32(h ^ salt)
    if at is None:
        pos = torch.arange(x.numel(), device=x.device).view(x.shape)
    else:
        b, t, f = x.shape
        row, col, length = at
        rows = torch.arange(row, row + b, device=x.device)[:, None, None]
        cols = torch.arange(col, col + t, device=x.device)[None, :, None]
        pos = ((rows * length + cols) * f
               + torch.arange(f, device=x.device)[None, None, :])
    keep = mix32(h ^ pos) >= int(rate * 2 ** 32)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def split_heads(a: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, D / H)."""
    b, t, d = a.shape
    return a.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (B, T, H·Dh)."""
    b, h, t, dh = o.shape
    return o.transpose(1, 2).reshape(b, t, h * dh)


#: The MoE block's expert stacks, in ``switch_moe``'s argument order.
EXPERT_LEAVES = ("expert_w1", "expert_b1", "expert_w2", "expert_b2")


class _EncoderBlock(nn.Module):
    """The reference's ``_EncoderBlock``; modules named as flax names
    them (``LayerNorm_0``, ``Dense_0`` … ``Dense_3``), and with
    ``moe_experts`` the router ``moe_gate`` (D, E) and the expert stacks
    ``expert_w1`` (E, D, 4D), ``expert_b1`` (E, 4D), ``expert_w2`` (E,
    4D, D), ``expert_b2`` (E, D) in place of ``Dense_2`` and
    ``Dense_3``."""

    def __init__(self, d_model: int, n_heads: int, gen: torch.Generator,
                 dropout: float = 0.0, moe_experts: int = 0):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        self.moe_experts = moe_experts
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, 3 * d_model, gen, use_bias=False)
        self.Dense_1 = Dense(d_model, d_model, gen, use_bias=False)
        self.LayerNorm_1 = LayerNorm(d_model)
        if moe_experts > 0:
            e, f = moe_experts, 4 * d_model
            # flax's lecun_normal over (E, in, out): fan_in = E · in.
            self.moe_gate = nn.Parameter(torch.empty(d_model, e))
            lecun_normal_(self.moe_gate, d_model, gen)
            self.expert_w1 = nn.Parameter(torch.empty(e, d_model, f))
            lecun_normal_(self.expert_w1, e * d_model, gen)
            self.expert_b1 = nn.Parameter(torch.zeros(e, f))
            self.expert_w2 = nn.Parameter(torch.empty(e, f, d_model))
            lecun_normal_(self.expert_w2, e * f, gen)
            self.expert_b2 = nn.Parameter(torch.zeros(e, d_model))
        else:
            self.Dense_2 = Dense(d_model, 4 * d_model, gen)
            self.Dense_3 = Dense(4 * d_model, d_model, gen)

    def forward(self, x: torch.Tensor, attn: Attention,
                kv_mask: Optional[torch.Tensor] = None,
                drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                losses: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        q, k, v = self.Dense_0(self.LayerNorm_0(x)).chunk(3, dim=-1)
        o = attn(split_heads(q, self.n_heads), split_heads(k, self.n_heads),
                 split_heads(v, self.n_heads), kv_mask)
        x = x + self.Dense_1(merge_heads(o))
        if self.moe_experts > 0:
            out, aux = moe_ffn(self.LayerNorm_1(x), kv_mask, self.moe_gate,
                               *(getattr(self, n) for n in EXPERT_LEAVES))
            if losses is not None:
                losses.append(aux)
            return x + (out if drop is None else drop(out))
        h = F.gelu(self.Dense_2(self.LayerNorm_1(x)), approximate="tanh")
        if drop is not None:
            h = drop(h)
        return x + self.Dense_3(h)

    def macs(self, out: torch.Tensor) -> int:
        """The attention's multiply-adds for one example of ``out``
        (B = 1): q·kᵀ and p·v over every (query, key) pair; the
        projections count as ``Dense`` layers."""
        t, d = out.shape[-2], out.shape[-1]
        return 2 * t * t * d


def moe_ffn(h: torch.Tensor, kv_mask: Optional[torch.Tensor], gate_w,
            w1, b1, w2, b2, expert_axis=None):
    """The MoE block's FFN on (b, t, D) ``h``: ``switch_moe`` over its
    b·t tokens in ``layers.COMPUTE`` (the router in f32), padding
    masked; with ``expert_axis`` the expert leaves are the ep ranks'
    slices. Returns ((b, t, D) out, aux)."""
    b, t, d = h.shape
    mask = None if kv_mask is None else kv_mask.reshape(b * t)

    def cast(w):
        return ([layers.cast(x) for x in w] if expert_axis is not None
                else layers.cast(w))

    out, aux = switch_moe(layers.cast(h).reshape(b * t, d), gate_w,
                          *(cast(w) for w in (w1, b1, w2, b2)),
                          token_mask=mask, expert_axis=expert_axis)
    return out.reshape(b, t, d), aux


def quantized_encoder_block(qvars: Dict[str, torch.Tensor],
                            scales: Dict[str, torch.Tensor],
                            fvars: Dict[str, torch.Tensor], prefix: str,
                            x: torch.Tensor, attn: Attention, n_heads: int,
                            kv_mask: Optional[torch.Tensor] = None
                            ) -> Optional[torch.Tensor]:
    """One dense-FFN ``_EncoderBlock`` in f32 on int8 kernels (ref
    :129-185): each projection ``dynamic_int8_matmul`` (a kernel left in
    f32 runs an f32 product), the LayerNorms in f32, the attention on f32
    q, k and v. ``prefix`` is the block's flat path
    (``params/_EncoderBlock_0``). None for an MoE block."""
    from ..model.torch_model import dynamic_int8_matmul

    if f"{prefix}/moe_gate" in fvars or f"{prefix}/moe_gate" in qvars:
        return None

    def ln(h, name):
        g = fvars[f"{prefix}/{name}/scale"].float()
        b = fvars[f"{prefix}/{name}/bias"].float()
        hf = h.float()
        m = hf.mean(-1, keepdim=True)
        v = ((hf - m) ** 2).mean(-1, keepdim=True)
        return (hf - m) * torch.rsqrt(v + 1e-6) * g + b

    def dense(h, name):
        k = f"{prefix}/{name}/kernel"
        flat2d = h.reshape(-1, h.shape[-1])
        if k in qvars:
            out = dynamic_int8_matmul(flat2d, qvars[k], scales[k])
        else:
            out = flat2d @ fvars[k].float()
        out = out.reshape(*h.shape[:-1], out.shape[-1])
        bkey = f"{prefix}/{name}/bias"
        if bkey in fvars:
            out = out + fvars[bkey].float()
        return out

    x = x.float()
    q, k, v = dense(ln(x, "LayerNorm_0"), "Dense_0").chunk(3, dim=-1)
    o = attn(split_heads(q, n_heads), split_heads(k, n_heads),
             split_heads(v, n_heads), kv_mask)
    x = x + dense(merge_heads(o), "Dense_1")
    h = F.gelu(dense(ln(x, "LayerNorm_1"), "Dense_2"), approximate="tanh")
    return x + dense(h, "Dense_3")


class _TransformerTagger(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, n_heads: int,
                 n_layers: int, n_tags: int, max_len: int, dropout: float,
                 seed: int, moe_experts: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.seed, self.dropout, self.n_layers = seed, dropout, n_layers
        self.Embed_0 = Embed(vocab_size, d_model, gen, layers.COMPUTE)
        for i in range(n_layers):
            setattr(self, f"_EncoderBlock_{i}",
                    _EncoderBlock(d_model, n_heads, gen, dropout,
                                  moe_experts))
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, n_tags, gen, f32=True)
        self.register_buffer("pe", torch.from_numpy(
            _sinusoidal(max_len, d_model)), persistent=False)

    def forward(self, ids: torch.Tensor, attn: Attention,
                step: Optional[torch.Tensor] = None,
                losses: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """(B, T) int64 ids -> (B, T, n_tags) f32 logits; dropout when
        ``step`` (the device step) is given; the MoE blocks' load-balance
        losses appended to ``losses`` when given."""
        kv_mask = ids != PAD_ID
        x = self.Embed_0(ids)
        x = x + self.pe[None, :ids.shape[1]].to(x.dtype)
        for i in range(self.n_layers):
            drop = None
            if step is not None and self.dropout > 0:
                def drop(h, i=i):
                    return hashed_dropout(h, self.dropout, self.seed + 1,
                                          step, i)
            x = getattr(self, f"_EncoderBlock_{i}")(x, attn, kv_mask, drop,
                                                     losses)
        return self.Dense_0(self.LayerNorm_0(x))


def _call(module: nn.Module, get: Callable[[str], torch.Tensor], *args):
    """``module(*args)`` on the parameters ``get(name)`` gives."""
    return functional_call(module, {n: get(n) for n, _ in
                                    module.named_parameters()}, args)


class _Shard(NamedTuple):
    """One rank's slice of the activations on the mesh."""

    coord: Tuple[int, ...]  # its mesh coordinate, ep index 0
    x: torch.Tensor  # (b, t, D) on the coordinate's device
    mask: torch.Tensor  # (b, t) bool, True for a real token
    origin: Tuple[int, int]  # (row, position) of x[0, 0] in the batch
    aux: Any = 0.0  # its MoE load-balance losses inside the pipeline


class TorchTransformerTagger(_CorpusTagger):
    """Transformer token tagger (POS_TAGGING): ``default_attention`` on
    one device, or the parallel modes on its ``mesh``."""

    default_max_len = 128

    @staticmethod
    def get_knob_config():
        return {
            "d_model": CategoricalKnob([64, 128, 256]),
            "n_heads": CategoricalKnob([2, 4, 8]),
            "n_layers": IntegerKnob(1, 6),
            "learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([16, 32, 64]),
            "max_epochs": IntegerKnob(3, 30),
            "max_len": CategoricalKnob([32, 64, 128, 256, 512]),
            "dropout": FloatKnob(0.0, 0.3),
            "vocab_size": FixedKnob(16384),
            # > 1 shards the sequence over sp mesh entries.
            "sequence_parallel": FixedKnob(1),
            # "ring" or "alltoall" (Ulysses; n_heads % sp == 0).
            "sp_schedule": FixedKnob("ring"),
            # > 0: Switch-routed expert FFNs, sliced over expert_parallel.
            "moe_experts": FixedKnob(0),
            "expert_parallel": FixedKnob(1),
            # > 1: the blocks as a GPipe pipeline (n_layers % pp == 0).
            "pipeline_parallel": FixedKnob(1),
            # Microbatches a pipeline step; 0 = auto (~4·pp).
            "pp_microbatches": FixedKnob(0),
            "seed": FixedKnob(0),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        self.attention = default_attention(causal=False)
        self._mesh: Optional[Mesh] = None

    def _knob(self, name: str, default: int) -> int:
        return int(self.knobs.get(name, default))

    @property
    def mesh(self) -> Mesh:
        """The (dp, pp, ep, sp, tp) mesh over the bound group's devices,
        or over the model's device alone (ref :279-299)."""
        if self._mesh is None:
            sp = self._knob("sequence_parallel", 1)
            ep = self._knob("expert_parallel", 1)
            pp = self._knob("pipeline_parallel", 1)
            experts = self._knob("moe_experts", 0)
            if ep > 1 and (experts == 0 or experts % ep != 0):
                raise ValueError(
                    f"expert_parallel ({ep}) needs moe_experts set and "
                    f"divisible by it (got moe_experts={experts})")
            if pp > 1:
                n_layers = self._knob("n_layers", 2)
                if n_layers % pp != 0:
                    raise ValueError(f"pipeline_parallel ({pp}) must "
                                     f"divide n_layers ({n_layers})")
            mesh = group_mesh(self.device, sp=sp, ep=ep, pp=pp)
            if mesh.spans_processes and (sp > 1 or ep > 1 or pp > 1
                                         or experts > 0):
                raise dist.CrossProcessAxisError(
                    "the transformer tagger runs only its dp mode over "
                    "several processes: sequence_parallel, "
                    "expert_parallel, pipeline_parallel and moe_experts "
                    "across processes are ROADMAP queue 1 item 8 (e)")
            self._mesh = mesh
        return self._mesh

    def batch_multiple(self) -> int:
        return self.mesh.shape["dp"]

    def create_module(self, n_tags: int) -> nn.Module:
        return _TransformerTagger(
            vocab_size=int(self.knobs.get("vocab_size", 16384)),
            d_model=int(self.knobs.get("d_model", 128)),
            n_heads=int(self.knobs.get("n_heads", 4)),
            n_layers=int(self.knobs.get("n_layers", 2)),
            n_tags=n_tags, max_len=self.max_len,
            dropout=float(self.knobs.get("dropout", 0.0)),
            seed=int(self.knobs.get("seed", 0)),
            moe_experts=self._knob("moe_experts", 0))

    def logits(self, net, ids, lengths, step=None):
        return self.train_logits(net, ids, lengths, step)[0]

    def train_logits(self, net, ids, lengths, step=None):
        """(logits, 0.01 · the MoE blocks' load-balance loss, or None
        for dense blocks) (ref :593-615)."""
        if self.mesh.size == 1:
            losses: List[torch.Tensor] = []
            out = net(ids, self.attention, step, losses)
            aux = sum(losses) if losses else None
        else:
            out, aux = self._mesh_forward(net, ids, step)
        return out, (None if aux is None else 0.01 * aux)

    def create_optimizer(self, params, total_steps: int):
        """``optax.adamw(warmup_cosine_decay_schedule(lr·0.1, lr,
        max(1, total // 10), total, lr·0.02), weight_decay=1e-3)`` (ref
        :580-586)."""
        total = max(1, total_steps)
        return scheduled_adamw(
            params, float(self.knobs.get("learning_rate", 1e-3)),
            warmup_cosine_decay_schedule(0.1, 1.0, max(1, total // 10),
                                         total, 0.02),
            total, weight_decay=1e-3)

    # --- The parallel modes ---

    def _attn_fn(self) -> Callable[..., List[torch.Tensor]]:
        """The attention over one row of sequence shards (lists of q, k,
        v and kv_mask shards), by the mesh's ``sp`` (ref :301-312):
        ``default_attention`` for one shard, else the ring or Ulysses.
        Bidirectional: tagging attends the whole sentence."""
        if self.mesh.shape["sp"] == 1:
            return lambda qs, ks, vs, ms: [self.attention(qs[0], ks[0], vs[0],
                                                          ms[0])]
        mode = str(self.knobs.get("sp_schedule", "ring"))
        if mode not in ("ring", "alltoall"):
            raise ValueError(f"unknown sequence-parallel mode {mode!r}")
        inner = ring_attention if mode == "ring" else ulysses_attention
        return lambda qs, ks, vs, ms: inner(qs, ks, vs, kv_masks=ms)

    def _pp_split(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Ordinary parameters (``named_parameters`` names) -> the pp
        layout: ``{"outer": ..., "stages": {"stage{j}": ...}}``, where
        stage leaf ``j`` stacks block ``s · span + j`` of every stage
        ``s`` (ref :326-339). Differentiable: a stack of the leaves."""
        pp = self._knob("pipeline_parallel", 1)
        span = self._knob("n_layers", 2) // pp
        outer = {k: v for k, v in params.items()
                 if not k.startswith("_EncoderBlock_")}
        names = [k.split(".", 1)[1] for k in params
                 if k.startswith("_EncoderBlock_0.")]
        stages = {f"stage{j}": {n: torch.stack(
            [params[f"_EncoderBlock_{s * span + j}.{n}"] for s in range(pp)])
            for n in names} for j in range(span)}
        return {"outer": outer, "stages": stages}

    def _pp_merge(self, pp_params: Dict[str, Any]
                  ) -> Dict[str, torch.Tensor]:
        """The pp layout -> ordinary parameters (the inverse of
        ``_pp_split``, ref :341-351)."""
        pp = self._knob("pipeline_parallel", 1)
        span = self._knob("n_layers", 2) // pp
        out = dict(pp_params["outer"])
        for j in range(span):
            for n, a in pp_params["stages"][f"stage{j}"].items():
                for s in range(pp):
                    out[f"_EncoderBlock_{s * span + j}.{n}"] = a[s]
        return out

    def _mesh_forward(self, net: nn.Module, ids: torch.Tensor,
                      step: Optional[torch.Tensor]):
        """The forward over the mesh (ref :353-501, :591-608): the batch's
        rows over dp, its positions over sp, each rank's embedding, the
        blocks (pipelined over pp when ``pipeline_parallel`` > 1), each
        rank's head; the logits gathered on the model's device. Returns
        (logits, the MoE load-balance loss or None)."""
        mesh = self.mesh
        dp, pp, sp = (mesh.shape[a] for a in ("dp", "pp", "sp"))
        n_b, n_t = ids.shape
        if n_b % dp or n_t % sp:
            raise ValueError(f"a batch of {n_b} x {n_t} ids does not "
                             f"divide over dp={dp} and sp={sp}")
        b, t = n_b // dp, n_t // sp
        params = dict(net.named_parameters())
        placed = shard_variables(self._pp_split(params) if pp > 1
                                 else params, mesh)
        outer = placed["outer"] if pp > 1 else placed
        rate = net.dropout if step is not None else 0.0

        def drop(x, origin, layer):
            if rate <= 0.0:
                return x
            return hashed_dropout(x, rate, net.seed + 1, step.to(x.device),
                                  layer, (origin[0], origin[1], n_t))

        grid = []
        for i in mesh.local_ranks():
            row = []
            for j in range(sp):
                c = (i, 0, 0, j, 0)
                dev = mesh.device(c)
                ids_s = ids[i * b:(i + 1) * b, j * t:(j + 1) * t].to(
                    dev, non_blocking=True)
                x = _call(net.Embed_0, lambda n, c=c: outer[
                    f"Embed_0.{n}"].at(c), ids_s)
                x = x + net.pe[j * t:(j + 1) * t].to(dev)[None].to(x.dtype)
                row.append(_Shard(c, x, ids_s != PAD_ID, (i * b, j * t)))
            grid.append(row)
        if pp == 1:
            losses: List[torch.Tensor] = []
            for layer in range(net.n_layers):
                grid = self._mesh_layer(
                    getattr(net, f"_EncoderBlock_{layer}"),
                    lambda c, n, L=layer: placed[
                        f"_EncoderBlock_{L}.{n}"].at(c),
                    grid, layer, drop, losses)
            aux = sum(losses) if losses else None
        else:
            grid, aux = self._pipeline(net, placed, grid, drop)
        rows = []
        for row in grid:
            outs = []
            for sh in row:
                def get(prefix, c=sh.coord):
                    return lambda n: outer[f"{prefix}.{n}"].at(c)

                h = _call(net.LayerNorm_0, get("LayerNorm_0"), sh.x)
                outs.append(_call(net.Dense_0, get("Dense_0"), h).to(
                    self.device, non_blocking=True))
            rows.append(torch.cat(outs, dim=1))
        if aux is not None:
            aux = aux.to(self.device)
        # Over several processes (dp only), every process's rows.
        return gather_ranks(mesh, [(0, b)] * dp, torch.stack(rows)).flatten(
            0, 1), aux

    def _mesh_layer(self, blk: _EncoderBlock,
                    get: Callable[[Tuple[int, ...], str], torch.Tensor],
                    grid: List[List[_Shard]], layer: int, drop,
                    losses: Optional[List[torch.Tensor]]
                    ) -> List[List[_Shard]]:
        """One encoder block over a grid of shards: a row is one batch
        shard's sequence shards. ``get(coord, name)`` is the block's
        parameter at a coordinate. With ``losses`` (outside the
        pipeline) a MoE block routes the grid's tokens together, in the
        whole batch's order, and appends its loss there; without, each
        shard routes its own tokens and adds the loss to its ``aux``."""
        mesh = self.mesh

        def call(mod, prefix, c, *args):
            return _call(mod, lambda n: get(c, f"{prefix}.{n}"), *args)

        attend = self._attn_fn()
        h_n = blk.n_heads
        out_rows = []
        for row in grid:
            qs, ks, vs = [], [], []
            for sh in row:
                q, k, v = call(blk.Dense_0, "Dense_0", sh.coord, call(
                    blk.LayerNorm_0, "LayerNorm_0", sh.coord, sh.x)).chunk(
                        3, dim=-1)
                qs.append(split_heads(q, h_n))
                ks.append(split_heads(k, h_n))
                vs.append(split_heads(v, h_n))
            os_ = attend(qs, ks, vs, [sh.mask for sh in row])
            out_rows.append([sh._replace(x=sh.x + call(
                blk.Dense_1, "Dense_1", sh.coord, merge_heads(o)))
                for sh, o in zip(row, os_)])
        grid = out_rows
        if not blk.moe_experts:
            out_rows = []
            for row in grid:
                new = []
                for sh in row:
                    h = F.gelu(call(blk.Dense_2, "Dense_2", sh.coord, call(
                        blk.LayerNorm_1, "LayerNorm_1", sh.coord, sh.x)),
                        approximate="tanh")
                    h = drop(h, sh.origin, layer)
                    new.append(sh._replace(x=sh.x + call(
                        blk.Dense_3, "Dense_3", sh.coord, h)))
                out_rows.append(new)
            return out_rows

        def moe(c, h, mask):
            ep = mesh.shape["ep"]
            gate = get(c, "moe_gate")
            if ep == 1:
                return moe_ffn(h, mask, gate,
                               *(get(c, n) for n in EXPERT_LEAVES))
            ranks = [c[:2] + (e,) + c[3:] for e in range(ep)]
            return moe_ffn(h, mask, gate, *([get(r, n) for r in ranks]
                                            for n in EXPERT_LEAVES),
                           expert_axis=[mesh.device(r) for r in ranks])

        hs = [[call(blk.LayerNorm_1, "LayerNorm_1", sh.coord, sh.x)
               for sh in row] for row in grid]
        if losses is None:
            out_rows = []
            for row, hrow in zip(grid, hs):
                new = []
                for sh, h in zip(row, hrow):
                    out, aux = moe(sh.coord, h, sh.mask)
                    new.append(sh._replace(
                        x=sh.x + drop(out, sh.origin, layer),
                        aux=sh.aux + aux))
                out_rows.append(new)
            return out_rows
        # The whole batch's tokens in its own order, on the first shard's
        # device: rows of shards stack, a row's shards join end to end.
        first = grid[0][0]
        dev = mesh.device(first.coord)
        h = torch.cat([torch.cat([x.to(dev, non_blocking=True) for x in hrow],
                                 dim=1) for hrow in hs], dim=0)
        mask = torch.cat([torch.cat([sh.mask.to(dev, non_blocking=True)
                                     for sh in row], dim=1) for row in grid],
                         dim=0)
        out, aux = moe(first.coord, h, mask)
        out = drop(out, first.origin, layer)
        losses.append(aux)
        b, t = first.x.shape[:2]
        return [[sh._replace(x=sh.x + out[i * b:(i + 1) * b,
                                          j * t:(j + 1) * t].to(
            sh.x.device, non_blocking=True)) for j, sh in enumerate(row)]
            for i, row in enumerate(grid)]

    def _pipeline(self, net: nn.Module, placed: Dict[str, Any],
                  grid: List[List[_Shard]], drop):
        """The blocks as a GPipe pipeline, each batch shard's row on its
        own (ref :419-486): stage ``s`` holds blocks ``s·span`` to
        ``(s+1)·span - 1`` on the coordinates (i, s, ., j, 0); the
        microbatches are ``pp_microbatches`` or the largest divisor of
        the shard's rows up to 4·pp. Returns the rows on the last stage
        and the mean MoE loss over the shards and microbatches (None for
        dense blocks)."""
        mesh = self.mesh
        pp = mesh.shape["pp"]
        span = net.n_layers // pp
        micro = self._knob("pp_microbatches", 0)
        moe = self._knob("moe_experts", 0) > 0
        stages = placed["stages"]
        out_grid, auxes = [], []
        for i, row in enumerate(grid):
            b = row[0].x.shape[0]
            if micro > 0:
                if b % micro:
                    raise ValueError(
                        f"pp_microbatches ({micro}) must divide the "
                        f"per-dp-shard batch ({b})")
                m = micro
            else:
                m = min(b, 4 * pp)
                while b % m:
                    m -= 1
            mb = b // m

            def place(tree, s, i=i):
                xs, ms, aux = tree
                devs = [mesh.device((i, s, 0, j, 0)) for j in range(len(xs))]
                return tuple([a.to(d, non_blocking=True) for a, d in
                              zip(part, devs)] for part in (xs, ms, aux))

            def stage_fn(s, tree, tick, i=i, row=row, mb=mb):
                xs, ms, aux = tree
                r0 = row[0].origin[0] + (tick - s) * mb
                shards = [[_Shard((i, s, 0, j, 0), x, msk, (r0, sh.origin[1]),
                                  a) for j, (sh, x, msk, a) in
                           enumerate(zip(row, xs, ms, aux))]]
                for jj in range(span):
                    shards = self._mesh_layer(
                        getattr(net, f"_EncoderBlock_{s * span + jj}"),
                        lambda c, n, jj=jj: stages[f"stage{jj}"][n].at(c)[0],
                        shards, s * span + jj, drop, None)
                row_out = shards[0]
                return ([sh.x for sh in row_out], [sh.mask for sh in row_out],
                        [torch.as_tensor(sh.aux, dtype=torch.float32,
                                         device=sh.x.device)
                         for sh in row_out])

            xs = [sh.x.reshape(m, mb, *sh.x.shape[1:]) for sh in row]
            ms = [sh.mask.reshape(m, mb, -1) for sh in row]
            zs = [torch.zeros(m, device=sh.x.device) for sh in row]
            out_x, out_m, out_aux = pipeline_apply(
                stage_fn, list(range(pp)), (xs, ms, zs), place=place,
                stage_takes_tick=True)
            out_grid.append([_Shard((i, pp - 1, 0, j, 0),
                                    x.reshape(b, *x.shape[2:]),
                                    msk.reshape(b, -1), sh.origin)
                             for j, (sh, x, msk) in
                             enumerate(zip(row, out_x, out_m))])
            auxes.extend(a.to(self.device) for a in out_aux)
        aux = torch.stack(auxes).mean() if moe else None
        return out_grid, aux
