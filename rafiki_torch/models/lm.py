"""TorchTransformerLM: the port of the flagship causal LM.

The counterpart of ``rafiki_tpu/models/lm.py`` (``JaxTransformerLM``):
the same knob config, the same shapes (``_dims``), the same flat
parameter dict through ``load_parameters``/``dump_parameters``, and the
same numerics:

- layer norm without bias, ``rsqrt(var + 1e-6)``, in f32, times ``g``;
- a bf16 residual stream: the embedding in bf16 times ``bf16(√d)``, the
  sinusoidal position table added in bf16, each residual add cast back
  to the stream's dtype;
- bf16 matmuls on bf16 casts of the f32 master weights, the tanh GELU,
  and the tied unembedding in bf16 cast to f32;
- causal attention through ``ops.flash_attention``: the Hopper kernel K1
  on the card, its plain version on the CPU.

Serving (``predict``) and ``evaluate`` are ported. Training needs the
backward kernels and comes with them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..model import (CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob,
                     PolicyKnob)
from ..model.base import BaseModel, Params
from ..model.bridge import lm_from_jax, lm_to_jax, n_layers_of
from ..model.dataset import load_token_dataset
from ..ops.attention import flash_attention
from ..torchenv import DeviceLike, resolve_device
from .transformer import _sinusoidal


def _layer_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    v = ((xf - m) ** 2).mean(-1, keepdim=True)
    return (xf - m) * torch.rsqrt(v + 1e-6) * g


class _Block(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(d))
        self.qkv = nn.Linear(d, 3 * d, bias=False)
        self.proj = nn.Linear(d, d, bias=False)
        self.ln2 = nn.Parameter(torch.ones(d))
        self.w1 = nn.Linear(d, 4 * d, bias=False)
        self.w2 = nn.Linear(4 * d, d, bias=False)


class _LMNet(nn.Module):
    """The f32 master weights; ``forward`` lives on the model, which
    holds the bf16 casts it runs on."""

    def __init__(self, v: int, d: int, layers: int):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(v, d))
        self.lnf = nn.Parameter(torch.ones(d))
        self.blocks = nn.ModuleList(_Block(d) for _ in range(layers))


class TorchTransformerLM(BaseModel):
    """Decoder-only causal transformer LM on the port's flash kernel."""

    @staticmethod
    def get_knob_config():
        return {
            "d_model": CategoricalKnob([256, 512, 1024, 2048]),
            "n_layers": IntegerKnob(2, 16),
            "seq_len": CategoricalKnob([256, 512, 1024, 2048, 4096]),
            "batch_size": CategoricalKnob([2, 4, 8, 16]),
            "learning_rate": FloatKnob(1e-4, 1e-2, is_exp=True),
            "train_steps": IntegerKnob(20, 20000),
            "vocab_size": CategoricalKnob([512, 4096, 16384, 32768]),
            "remat": FixedKnob("dots"),
            "steps_per_dispatch": FixedKnob(8),
            "quick_train": PolicyKnob("QUICK_TRAIN"),
            "trial_steps": FixedKnob(30),
            "seed": FixedKnob(0),
        }

    def __init__(self, *, device: DeviceLike = None, **knobs: Any):
        super().__init__(**knobs)
        self.device = resolve_device(device)
        self._net: _LMNet = None
        self._bf16: Dict[str, torch.Tensor] = None
        self._pos: torch.Tensor = None   # bf16 position table
        # The attention the blocks call; a check may swap in the plain
        # version to hold the kernel's path against it.
        self.attention = flash_attention

    def _dims(self):
        d = int(self.knobs.get("d_model", 1024))
        return dict(
            d=d,
            h=max(1, d // 128),
            layers=int(self.knobs.get("n_layers", 8)),
            t=int(self.knobs.get("seq_len", 1024)),
            v=int(self.knobs.get("vocab_size", 32768)),
        )

    # --- forward ---

    def _weights(self) -> Dict[str, torch.Tensor]:
        """bf16 casts of the master weights, made once per load."""
        if self._net is None:
            raise RuntimeError("load_parameters() first")
        if self._bf16 is None:
            with torch.no_grad():
                self._bf16 = {k: p.to(torch.bfloat16)
                              for k, p in self._net.named_parameters()}
        return self._bf16

    def _block(self, x, w, i: int, h_heads: int):
        p = f"blocks.{i}."
        b, t, d = x.shape
        h = _layer_norm(x, self._net.blocks[i].ln1).to(torch.bfloat16)
        q, k, v = F.linear(h, w[p + "qkv.weight"]).split(d, dim=-1)

        def heads(a):
            return a.reshape(b, t, h_heads, d // h_heads).transpose(
                1, 2).contiguous()

        o = self.attention(heads(q), heads(k), heads(v), causal=True)
        o = o.transpose(1, 2).reshape(b, t, d)
        x = x + F.linear(o, w[p + "proj.weight"]).to(x.dtype)
        h = _layer_norm(x, self._net.blocks[i].ln2).to(torch.bfloat16)
        h = F.gelu(F.linear(h, w[p + "w1.weight"]), approximate="tanh")
        return x + F.linear(h, w[p + "w2.weight"]).to(x.dtype)

    @torch.no_grad()
    def _forward(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, T) int64 ids on the model's device -> (B, T, V) f32
        logits."""
        s = self._dims()
        w = self._weights()
        x = w["embed"][ids] * torch.tensor(math.sqrt(s["d"]),
                                           dtype=torch.bfloat16)
        x = x + self._pos[None, :ids.shape[1]]
        for i in range(len(self._net.blocks)):
            x = self._block(x, w, i, s["h"])
        x = _layer_norm(x, self._net.lnf).to(torch.bfloat16)
        return (x @ w["embed"].T).float()

    # --- BaseModel ---

    def train(self, dataset_path: str, **kwargs: Any) -> None:
        raise NotImplementedError(
            "TorchTransformerLM.train needs the flash-attention backward "
            "kernels (dq; dk+dv), which the next slice of the port adds")

    def evaluate(self, dataset_path: str) -> float:
        """Mean next-token accuracy over up to 16 contiguous windows, as
        the reference computes it."""
        ds = load_token_dataset(dataset_path)
        t = self._dims()["t"]
        n_win = max(1, min(16, (ds.size - 1) // t))
        wins = np.stack([ds.ids[i * t:i * t + t + 1] for i in range(n_win)])
        wins = torch.from_numpy(wins.astype(np.int64)).to(self.device)
        logits = self._forward(wins[:, :-1])
        return float((logits.argmax(-1) == wins[:, 1:]).float().mean())

    def predict(self, queries: List[Any]) -> List[Any]:
        """Scores token-id sequences: mean next-token log-probability
        per query. One padded forward per query, as the reference does;
        a query with fewer than 2 ids scores 0.0."""
        if not queries:
            return []
        t = self._dims()["t"]
        out = []
        for q in queries:
            ids = np.asarray(list(q), np.int64)[:t + 1]
            if ids.size < 2:
                out.append(0.0)
                continue
            pad = np.zeros((t + 1,), np.int64)
            pad[:ids.size] = ids
            logits = self._forward(
                torch.from_numpy(pad[None, :-1]).to(self.device))[0]
            lp = torch.log_softmax(logits, -1)
            n = ids.size - 1
            tgt = torch.from_numpy(ids[1:, None]).to(self.device)
            out.append(float(lp[:n].gather(-1, tgt).mean()))
        return out

    def dump_parameters(self) -> Params:
        if self._net is None:
            raise RuntimeError("load_parameters() first")
        return lm_to_jax(self._net.state_dict())

    def load_parameters(self, params: Params) -> None:
        s = self._dims()
        with torch.device("meta"):
            net = _LMNet(s["v"], s["d"], n_layers_of(params))
        net.load_state_dict(lm_from_jax(params), assign=True)
        self._net = net.to(self.device).eval()
        self._bf16 = None
        self._pos = torch.from_numpy(_sinusoidal(s["t"], s["d"])).to(
            self.device, torch.bfloat16)

    def destroy(self) -> None:
        self._net = None
        self._bf16 = None
        self._pos = None
