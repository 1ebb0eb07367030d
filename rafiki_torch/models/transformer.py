"""The transformer zoo's shared blocks and ``TorchTransformerTagger``.

The counterpart of the reference's ``models/transformer.py``:

- ``_EncoderBlock`` (ref :61-127): pre-LN, a bias-free QKV projection
  and output projection, the attention injected by the caller
  (``ops.default_attention``: K1 on the card, with K2 and K3 for the
  gradient; the blockwise formulation on the CPU), then a biased 4×
  FFN with flax's tanh ``gelu``. LayerNorms in f32 (eps 1e-6), the
  projections in ``layers.COMPUTE`` (bf16) on f32 parameters. Only the
  dense FFN is ported: ``moe_experts`` above 0 raises.
- ``quantized_encoder_block`` (ref :129-185): the same block in f32 on
  ``dynamic_int8_matmul``, for int8 serving.
- ``_TransformerTagger`` and ``TorchTransformerTagger`` (ref
  :188-758): an ``Embed`` in ``layers.COMPUTE`` (bf16) plus the
  sinusoidal table, the blocks
  with ``kv_mask = ids != PAD_ID``, an f32 LayerNorm and an f32 head.
  Training is ``optax.adamw`` (weight decay 1e-3) under the warm-up
  cosine from ``lr·0.1`` to ``lr`` over ``total // 10`` steps and down
  to ``lr·0.02`` (``scheduled_adamw``), on the corpus taggers' shared
  loop (``pos_tagger._CorpusTagger``). Dropout draws come from
  ``utils.hashing.mix32`` of (seed, step, layer, position), not from
  ``jax.random``, so a captured step would draw anew at each replay.

Only the single-device path is ported: ``sequence_parallel``,
``expert_parallel`` and ``pipeline_parallel`` above 1 and
``moe_experts`` above 0 raise ``NotImplementedError`` (ROADMAP queue 1
item 8); the reference's knob space pins them to 1 and 0.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..model import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from ..model.dataset import PAD_ID
from ..model.optim import scheduled_adamw, warmup_cosine_decay_schedule
from ..ops.attention import default_attention
from ..utils.hashing import M32, mix32
from . import layers
from .layers import Dense, Embed, LayerNorm
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
                   step: torch.Tensor, salt: int) -> torch.Tensor:
    """flax's ``Dropout``, ``where(keep, x / (1 − rate), 0)``, with
    ``keep`` drawn from ``mix32`` of (``seed``, the device step
    ``step``, ``salt``, each element's position): no generator state is
    read, so eager steps and graph replays draw alike."""
    if rate <= 0.0:
        return x
    h = mix32(mix32(torch.full_like(step, seed & M32)) ^ (step & M32))
    h = mix32(h ^ salt)
    pos = torch.arange(x.numel(), device=x.device).view(x.shape)
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


class _EncoderBlock(nn.Module):
    """The reference's dense-FFN ``_EncoderBlock``; modules named as
    flax names them (``LayerNorm_0``, ``Dense_0`` … ``Dense_3``)."""

    def __init__(self, d_model: int, n_heads: int, gen: torch.Generator,
                 dropout: float = 0.0):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, 3 * d_model, gen, use_bias=False)
        self.Dense_1 = Dense(d_model, d_model, gen, use_bias=False)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.Dense_2 = Dense(d_model, 4 * d_model, gen)
        self.Dense_3 = Dense(4 * d_model, d_model, gen)

    def forward(self, x: torch.Tensor, attn: Attention,
                kv_mask: Optional[torch.Tensor] = None,
                drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> torch.Tensor:
        q, k, v = self.Dense_0(self.LayerNorm_0(x)).chunk(3, dim=-1)
        o = attn(split_heads(q, self.n_heads), split_heads(k, self.n_heads),
                 split_heads(v, self.n_heads), kv_mask)
        x = x + self.Dense_1(merge_heads(o))
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
                 seed: int):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.seed, self.dropout, self.n_layers = seed, dropout, n_layers
        self.Embed_0 = Embed(vocab_size, d_model, gen, layers.COMPUTE)
        for i in range(n_layers):
            setattr(self, f"_EncoderBlock_{i}",
                    _EncoderBlock(d_model, n_heads, gen, dropout))
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, n_tags, gen, f32=True)
        self.register_buffer("pe", torch.from_numpy(
            _sinusoidal(max_len, d_model)), persistent=False)

    def forward(self, ids: torch.Tensor, attn: Attention,
                step: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T) int64 ids -> (B, T, n_tags) f32 logits; dropout when
        ``step`` (the device step) is given."""
        kv_mask = ids != PAD_ID
        x = self.Embed_0(ids)
        x = x + self.pe[None, :ids.shape[1]].to(x.dtype)
        for i in range(self.n_layers):
            drop = None
            if step is not None and self.dropout > 0:
                def drop(h, i=i):
                    return hashed_dropout(h, self.dropout, self.seed + 1,
                                          step, i)
            x = getattr(self, f"_EncoderBlock_{i}")(x, attn, kv_mask, drop)
        return self.Dense_0(self.LayerNorm_0(x))


class TorchTransformerTagger(_CorpusTagger):
    """Transformer token tagger (POS_TAGGING) on ``default_attention``."""

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
            "sequence_parallel": FixedKnob(1),
            "sp_schedule": FixedKnob("ring"),
            "moe_experts": FixedKnob(0),
            "expert_parallel": FixedKnob(1),
            "pipeline_parallel": FixedKnob(1),
            "pp_microbatches": FixedKnob(0),
            "seed": FixedKnob(0),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        for name, off in (("sequence_parallel", 1), ("expert_parallel", 1),
                          ("pipeline_parallel", 1), ("moe_experts", 0)):
            if int(self.knobs.get(name, off)) != off:
                raise NotImplementedError(
                    f"{name}={self.knobs[name]}: the tagger's "
                    "sequence-, expert- and pipeline-parallel paths and its "
                    "MoE blocks are not ported yet (ROADMAP queue 1 item 8)")
        self.attention = default_attention(causal=False)

    def create_module(self, n_tags: int) -> nn.Module:
        return _TransformerTagger(
            vocab_size=int(self.knobs.get("vocab_size", 16384)),
            d_model=int(self.knobs.get("d_model", 128)),
            n_heads=int(self.knobs.get("n_heads", 4)),
            n_layers=int(self.knobs.get("n_layers", 2)),
            n_tags=n_tags, max_len=self.max_len,
            dropout=float(self.knobs.get("dropout", 0.0)),
            seed=int(self.knobs.get("seed", 0)))

    def logits(self, net, ids, lengths, step=None):
        return net(ids, self.attention, step)

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
