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
- causal attention through ``ops.flash_attention``: the Hopper kernels
  on the card (K1 forward, K2 and K3 backward), their plain versions on
  the CPU.

``train`` is the counterpart of the reference's: device-side init from
the ``seed`` knob unless parameters were loaded, windows cut on the host
from ``epoch_rng(seed, 0)`` exactly as the reference cuts them, f32
cross-entropy on f32 logits, AdamW under the reference's warmup-cosine
schedule, the ``remat`` policies, and one log record per
``steps_per_dispatch`` steps. Its ``mesh`` (ref :145-148) is
data-parallel over the devices of the group bound to the thread, or the
model's device alone: the batch is rounded down to a multiple of dp (at
least dp), each rank runs the forward and backward of its windows on its
device (K1, then K2 and K3, on its own shard), the loss and the token
accuracy are the whole batch's means, and one AdamW update follows.
``evaluate`` runs each rank's windows on its device too; ``predict`` and
generation stay on the model's device (the reference's replicated
parameters). ``predict`` and ``evaluate`` run on bf16
casts of the weights cached once per load; training takes the casts
inside the graph, so the gradient reaches the f32 master weights.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..model import (CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob,
                     PolicyKnob)
from ..model.base import BaseModel, Params
from ..model.bridge import LINEARS, lm_from_jax, lm_to_jax, n_layers_of
from ..model.dataset import load_token_dataset
from ..model.logger import logger
from ..model.loop_ckpt import epoch_rng
from ..model.optim import adamw, warmup_cosine_decay_schedule
from ..model.torch_model import (stage_bytes_limit, stage_cache_budget,
                                 staged_token_ids)
from ..observe import MfuMeter, metrics
from ..ops.attention import flash_attention
from ..parallel.data import (gather_ranks, group_mesh, rank_coord,
                             row_blocks, sum_grads)
from ..parallel.mesh import Mesh, shard_variables
from ..torchenv import DeviceLike, resolve_device
from .transformer import _sinusoidal


def _layer_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    v = ((xf - m) ** 2).mean(-1, keepdim=True)
    return (xf - m) * torch.rsqrt(v + 1e-6) * g


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matrix products without
    batch dimensions (every projection is an ``mm``), as the reference's
    ``dots_with_no_batch_dims_saveable`` does; recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


Weights = Callable[[str], torch.Tensor]


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
        self._mesh: Optional[Mesh] = None
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

    @property
    def mesh(self) -> Mesh:
        """The data-parallel mesh over the devices of the group bound to
        the thread, or over the model's device alone (ref :145-148)."""
        if self._mesh is None:
            self._mesh = group_mesh(self.device)
        return self._mesh

    # --- forward ---

    def _weights(self) -> Dict[str, torch.Tensor]:
        """bf16 casts of the master weights for predict and evaluate,
        made once per load."""
        if self._net is None:
            raise RuntimeError("load_parameters() first")
        if self._bf16 is None:
            with torch.no_grad():
                self._bf16 = {k: p.to(torch.bfloat16)
                              for k, p in self._net.named_parameters()}
        return self._bf16

    def _train_weight(self, name: str) -> torch.Tensor:
        """A fresh bf16 cast of one master weight, inside the graph: each
        use casts anew, as the reference does (the tied embedding and
        unembedding are two casts, whose gradients sum in f32)."""
        return self._net.get_parameter(name).to(torch.bfloat16)

    def _block(self, x, w: Weights, i: int, h_heads: int,
               kv: Optional[List[Any]] = None, g: Optional[Weights] = None):
        """One transformer block. ``kv``, when given, receives this
        layer's ``(k, v)`` rows, (B, T, d) bf16, before the heads split:
        the generative prefill stores them in its page pool. ``g`` gives
        the f32 norm gains (the master weights by default)."""
        p = f"blocks.{i}."
        g = g or self._net.get_parameter
        b, t, d = x.shape
        h = _layer_norm(x, g(p + "ln1")).to(torch.bfloat16)
        q, k, v = F.linear(h, w(p + "qkv.weight")).split(d, dim=-1)
        if kv is not None:
            kv.append((k, v))

        def heads(a):
            return a.reshape(b, t, h_heads, d // h_heads).transpose(
                1, 2).contiguous()

        o = self.attention(heads(q), heads(k), heads(v), causal=True)
        o = o.transpose(1, 2).reshape(b, t, d)
        x = x + F.linear(o, w(p + "proj.weight")).to(x.dtype)
        h = _layer_norm(x, g(p + "ln2")).to(torch.bfloat16)
        h = F.gelu(F.linear(h, w(p + "w1.weight")), approximate="tanh")
        return x + F.linear(h, w(p + "w2.weight")).to(x.dtype)

    def _logits(self, ids: torch.Tensor, w: Weights,
                remat: str = "none", g: Optional[Weights] = None
                ) -> torch.Tensor:
        """The forward both paths share: (B, T) int64 ids on the device
        of ``w``'s weights -> (B, T, V) f32 logits, the norm gains from
        ``g`` (the master weights by default), the blocks under a
        ``remat`` policy (the reference's ``remat`` knob):

        - ``"none"`` keeps every activation for the backward;
        - ``"full"`` keeps each block's input only and reruns the block;
        - ``"dots"`` keeps the outputs of the matrix products and reruns
          the rest, K1 included (the attention is not a kept product).
        """
        s = self._dims()
        if remat == "none":
            block = self._block
        elif remat in ("full", "dots"):
            extra = {}
            if remat == "dots":
                extra["context_fn"] = functools.partial(
                    create_selective_checkpoint_contexts, _save_matmuls)
            block = functools.partial(checkpoint, self._block,
                                      use_reentrant=False, **extra)
        else:
            raise ValueError(f"unknown remat policy {remat!r}")
        g = g or self._net.get_parameter
        x = w("embed")[ids] * torch.tensor(math.sqrt(s["d"]),
                                           dtype=torch.bfloat16)
        x = x + self._pos[None, :ids.shape[1]].to(x.device)
        for i in range(len(self._net.blocks)):
            x = block(x, w, i, s["h"], g=g)
        x = _layer_norm(x, g("lnf")).to(torch.bfloat16)
        # Tied unembedding: logits in f32 for a stable softmax.
        return (x @ w("embed").T).float()

    @torch.no_grad()
    def _forward(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, T) int64 ids on the model's device -> (B, T, V) f32
        logits, on the cached casts."""
        return self._logits(ids, self._weights().__getitem__)

    def _loss(self, win: torch.Tensor):
        """(loss, token accuracy) of one (B, T + 1) window batch: f32
        cross-entropy and argmax agreement on f32 logits, the forward
        under the ``remat`` knob's policy and carrying gradients."""
        logits = self._logits(win[:, :-1], self._train_weight,
                              str(self.knobs.get("remat", "dots")))
        tgt = win[:, 1:]
        loss = F.cross_entropy(logits.flatten(0, 1), tgt.flatten())
        acc = (logits.detach().argmax(-1) == tgt).float().mean()
        return loss, acc

    def _mesh_loss(self, win: torch.Tensor):
        """``_loss`` over the mesh's dp ranks (ref :299, :308): each rank
        runs the forward, and so the backward, on its rows of the
        windows on its device, from its copies of the master weights
        (``shard_variables``: replicated, so the ranks' gradients add up
        in each weight's ``.grad``); the loss and the token accuracy are
        the whole batch's means, summed on the model's device."""
        mesh = self.mesh
        remat = str(self.knobs.get("remat", "dots"))
        placed = shard_variables(dict(self._net.named_parameters()), mesh)
        blocks = row_blocks(win.shape[0], mesh.shape["dp"])
        sums = []
        for i in mesh.local_ranks():
            lo, hi = blocks[i]
            c = rank_coord(i)
            w = win[lo:hi].to(mesh.device(c), non_blocking=True)
            logits = self._logits(
                w[:, :-1], lambda n, c=c: placed[n].at(c).to(torch.bfloat16),
                remat, lambda n, c=c: placed[n].at(c))
            tgt = w[:, 1:]
            loss = F.cross_entropy(logits.flatten(0, 1), tgt.flatten(),
                                   reduction="sum")
            hits = (logits.detach().argmax(-1) == tgt).sum().float()
            sums.append(torch.stack([loss, hits]).to(self.device))
        # Across processes, every rank's sums in rank order (what follows
        # is computed alike in every process).
        total = gather_ranks(mesh, blocks, torch.stack(sums)).sum(0) / (
            win.shape[0] * (win.shape[1] - 1))
        return total[0], total[1].detach()

    def _flops_per_step(self, b: int) -> float:
        """Analytic train-step FLOPs (fwd+bwd), as the reference counts
        them: 6·N·tokens for the matmul parameters (embedding gather
        excluded, tied unembedding included) plus the causal attention
        term."""
        s = self._dims()
        tokens = b * s["t"]
        n_mat = 12 * s["layers"] * s["d"] ** 2 + s["v"] * s["d"]
        attn = (2 * 2 * 3 * b * s["h"] * s["t"] ** 2
                * (s["d"] // s["h"]) * s["layers"] / 2)
        return 6 * n_mat * tokens + attn

    def _init_params(self) -> _LMNet:
        """The reference's initialisation, drawn on the device from a
        generator seeded by the ``seed`` knob: embedding N(0, 0.02²),
        projections N(0, 1/fan_in), norm gains 1."""
        s = self._dims()
        gen = torch.Generator(device=self.device).manual_seed(
            int(self.knobs.get("seed", 0)))
        with torch.device("meta"):
            net = _LMNet(s["v"], s["d"], s["layers"])
        net = net.to_empty(device=self.device)
        with torch.no_grad():
            net.embed.normal_(0.0, 0.02, generator=gen)
            net.lnf.fill_(1.0)
            for blk in net.blocks:
                for name in LINEARS:
                    w = getattr(blk, name).weight
                    w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]),
                              generator=gen)
                blk.ln1.fill_(1.0)
                blk.ln2.fill_(1.0)
        return net

    # --- BaseModel ---

    def train(self, dataset_path: str, **kwargs: Any) -> None:
        """Train for ``train_steps`` optimizer steps (``trial_steps``
        under ``quick_train``) on windows of the token stream, one log
        record of the chunk's mean loss and accuracy every
        ``steps_per_dispatch`` steps. The parameters stay on the
        device."""
        ds = load_token_dataset(dataset_path)
        s = self._dims()
        if ds.vocab_size > s["v"]:
            raise ValueError(f"dataset vocab {ds.vocab_size} exceeds model "
                             f"vocab {s['v']}")
        t = s["t"]
        if ds.size < t + 2:
            raise ValueError(
                f"token dataset has {ds.size} ids but seq_len={t} needs at "
                f"least {t + 2} (one full input+target window)")
        dp = self.mesh.shape["dp"]
        # A multiple of dp, at least dp (ref :259-260).
        b = max(dp, (int(self.knobs.get("batch_size", 8)) // dp) * dp)
        steps = int(self.knobs.get("train_steps", 100))
        if self.knobs.get("quick_train", False):
            steps = min(steps, int(self.knobs.get("trial_steps", 30)))
        k_disp = max(1, int(self.knobs.get("steps_per_dispatch", 8)))

        if self._net is None:
            self._install(self._init_params())
        self._bf16 = None
        lr = float(self.knobs.get("learning_rate", 3e-4))
        total = max(1, steps)
        schedule = warmup_cosine_decay_schedule(
            lr * 0.1, lr, max(1, total // 10), total, lr * 0.1)
        opt = adamw(self._net.parameters(), schedule(0))

        logger.define_plot("Training", ["loss", "token_acc", "chip_util"],
                           x_axis="step")
        # Utilization is a card's: on the CPU the step cost stays
        # unknown, so no chip_util and no MFU gauge.
        meter = MfuMeter(self._flops_per_step(b)
                         if self.device.type == "cuda" else None,
                         n_devices=self.mesh.size, device=self.device)
        mlabels = metrics.bound_labels()
        mfu_gauge = metrics.registry().gauge(
            "rafiki_tpu_train_mfu_ratio",
            "Model-FLOPs-utilization of the trial's chip group "
            "(published per epoch)")
        loss_of = self._loss if self.mesh.size == 1 else self._mesh_loss
        rng = epoch_rng(int(self.knobs.get("seed", 0)), 0)
        hi = max(1, ds.size - (t + 1))
        done = 0
        first_chunk = True
        while done < steps:
            k = min(k_disp, steps - done)
            starts = rng.integers(0, hi, size=k * b)
            wins = np.stack([ds.ids[i:i + t + 1] for i in starts])
            wins = torch.from_numpy(wins.astype(np.int64).reshape(
                k, b, t + 1)).to(self.device)
            sums = torch.zeros(2, dtype=torch.float32, device=self.device)
            for i in range(k):
                for group in opt.param_groups:
                    group["lr"] = schedule(done + i)
                opt.zero_grad(set_to_none=True)
                loss, acc = loss_of(wins[i])
                loss.backward()
                sum_grads(self.mesh, self._net.parameters())
                opt.step()
                sums += torch.stack([loss.detach(), acc])
            done += k
            loss_acc = (sums / k).tolist()  # the chunk's one host sync
            meter.tick(k)
            if first_chunk or k != k_disp:
                # The first chunk pays the kernels' first use and the
                # tail chunk is short: both stay out of the window.
                first_chunk = False
                meter.reset()
            mfu = meter.mfu
            util = {"chip_util": round(mfu, 6)} if mfu is not None else {}
            if mfu is not None:  # the reference publishes it a chunk
                # rta: disable=RTA301 bound trial= labels; TrialRunner removes them at trial end (worker/runner.py)
                mfu_gauge.set(mfu, **mlabels)
            logger.log(step=done, loss=loss_acc[0], token_acc=loss_acc[1],
                       **util)
        opt.zero_grad(set_to_none=True)

    def evaluate(self, dataset_path: str) -> float:
        """Mean next-token accuracy over up to 16 contiguous windows, as
        the reference computes it (ref :380-418), on the windows of
        ``_eval_windows``."""
        wins = self._eval_windows(dataset_path)
        if self.mesh.size > 1:
            return float(self._mesh_hits(wins)) / wins[:, 1:].numel()
        logits = self._forward(wins[:, :-1])
        return float((logits.argmax(-1) == wins[:, 1:]).float().mean())

    @torch.no_grad()
    def _mesh_hits(self, wins: torch.Tensor) -> torch.Tensor:
        """Next-token hits of ``wins`` over the mesh's dp ranks: each
        rank's windows through the forward on its device, on copies of
        the cached casts (the reference's replicated parameters)."""
        mesh = self.mesh
        bf16 = self._weights()
        hits = []
        blocks = row_blocks(wins.shape[0], mesh.shape["dp"])
        for i in mesh.local_ranks():
            lo, hi = blocks[i]
            if lo == hi:
                continue
            dev = mesh.device(rank_coord(i))
            w = wins[lo:hi].to(dev, non_blocking=True)
            logits = self._logits(
                w[:, :-1], lambda n, d=dev: bf16[n].to(d), "none",
                lambda n, d=dev: self._net.get_parameter(n).to(d))
            hits.append((logits.argmax(-1) == w[:, 1:]).sum().to(
                self.device))
        return gather_ranks(mesh, blocks, torch.stack(hits)).sum()

    def _eval_windows(self, dataset_path: str) -> torch.Tensor:
        """``evaluate``'s (n_win, T + 1) int64 windows on the device:
        window i is ids ``[i·T, i·T + T]`` of the stream, for up to 16.

        A stream the staging cache can hold (``0 < bytes <= min(
        RAFIKI_TPU_STAGE_BYTES, RAFIKI_TPU_STAGE_CACHE_BYTES)``, and long
        enough for every window) stays on the device across calls
        (``staged_token_ids``), and the windows are gathered there by
        indices made there: evaluations 2..N copy no ids. Otherwise the
        windows are cut on the host, as before; staging the whole stream
        uncached on every call would copy more than 16 windows. Both
        paths give the same windows."""
        ds = load_token_dataset(dataset_path)
        t = self._dims()["t"]
        n_win = max(1, min(16, (ds.size - 1) // t))
        if 0 < int(ds.ids.nbytes) <= min(stage_bytes_limit(),
                                           stage_cache_budget()) \
                and ds.size >= n_win * t + 1:
            ids_dev = staged_token_ids(dataset_path, ds, self.device)
            sel = (torch.arange(n_win, device=self.device)[:, None] * t
                   + torch.arange(t + 1, device=self.device)[None, :])
            return ids_dev[sel].long()
        wins = np.stack([ds.ids[i * t:i * t + t + 1] for i in range(n_win)])
        return torch.from_numpy(wins.astype(np.int64)).to(self.device)

    def predict(self, queries: List[Any]) -> List[Any]:
        """Scores token-id sequences: mean next-token log-probability
        per query. One padded forward per query, as the reference does;
        a query with fewer than 2 ids scores 0.0.

        Ids are checked on the host before anything launches, and each
        query gets the reference's answer: a negative id wraps once, as
        numpy-style indexing does; an input id still outside ``[0, V)``
        is clamped into it, as JAX's embedding gather clamps; a target
        id still outside it scores ``nan``, as JAX's
        ``take_along_axis`` fills, and such a query launches nothing."""
        if not queries:
            return []
        s = self._dims()
        t, v = s["t"], s["v"]
        out = []
        for q in queries:
            ids = np.asarray(list(q), np.int32)[:t + 1].astype(np.int64)
            if ids.size < 2:
                out.append(0.0)
                continue
            ids = np.where(ids < 0, ids + v, ids)
            tgt = ids[1:]
            if ((tgt < 0) | (tgt >= v)).any():
                out.append(float("nan"))
                continue
            pad = np.zeros((t + 1,), np.int64)
            pad[:ids.size] = np.clip(ids, 0, v - 1)
            logits = self._forward(
                torch.from_numpy(pad[None, :-1]).to(self.device))[0]
            lp = torch.log_softmax(logits, -1)
            n = ids.size - 1
            tgt = torch.from_numpy(tgt[:, None]).to(self.device)
            out.append(float(lp[:n].gather(-1, tgt).mean()))
        return out

    def make_generator(self, **cfg: Any):
        """Token-level generation engine over this model's parameters:
        paged KV cache, bucketed prefill on K1, one fixed-shape decode
        step (a CUDA graph on the card), admission between steps. See
        :mod:`rafiki_torch.models.lm_generate`; ``cfg`` passes through
        to :class:`LMGenerator` (``page_size``, ``n_pages``,
        ``decode_batch``, ``max_new_cap``, ``prefix_cache_entries``)."""
        from .lm_generate import LMGenerator

        if self._net is None:
            raise RuntimeError("train() or load_parameters() first")
        return LMGenerator(self, **cfg)

    def dump_parameters(self) -> Params:
        if self._net is None:
            raise RuntimeError("load_parameters() first")
        return lm_to_jax(self._net.state_dict())

    def load_parameters(self, params: Params) -> None:
        s = self._dims()
        with torch.device("meta"):
            net = _LMNet(s["v"], s["d"], n_layers_of(params))
        net.load_state_dict(lm_from_jax(params), assign=True)
        self._install(net.to(self.device))

    def _install(self, net: _LMNet) -> None:
        s = self._dims()
        self._net = net
        self._bf16 = None
        self._pos = torch.from_numpy(_sinusoidal(s["t"], s["d"])).to(
            self.device, torch.bfloat16)

    def destroy(self) -> None:
        self._net = None
        self._bf16 = None
        self._pos = None
