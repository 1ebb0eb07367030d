"""TorchPosTagger: the port of ``JaxPosTagger``, and the corpus taggers'
shared train, predict and parameter code.

The counterpart of ``rafiki_tpu/models/pos_tagger.py:37-289``: the same
knob config; tokens hashed into the vocabulary (``hash_token_ids``) and
padded or cut to ``max_len``; ``Embed``, a forward and a backward
``OptimizedLSTMCell`` over the padded row, their outputs concatenated
and a ``Dense`` to the tags, all in f32. Its ``mesh`` (ref :83-86) is
data-parallel over the devices of the group bound to the thread, or the
model's device alone; each rank runs its rows through its replica on its
device and the logits are gathered for the loss (ref :160-180). flax's forward ``RNN`` runs
over every position of the row, padding included (``seq_lengths`` only
picks its final carry, which the tagger does not read). The backward one
is ``RNN(reverse=True, keep_order=True)``: ``flip_sequences`` reverses
each row within its length and the padding within itself, the scan runs
over the flipped row, and the outputs flip back. So every position,
past the length too, matches the reference. Each direction runs as one
``torch.lstm`` over the row (cuDNN on the card), on ``nn.LSTMCell``
tensors that the bridge maps from flax's eight gate layers.

``_CorpusTagger`` is what the BiLSTM and ``TorchTransformerTagger``
share (the reference's two classes repeat it): the whole encoded set
on the device once; each epoch's order ``epoch_rng(seed,
epoch).permutation(size)``, a short last batch filled by ``np.resize``;
the loss the cross-entropy masked by each sentence's length (plus
what ``train_logits`` adds, the transformer's MoE term), token accuracy
alike, one log record an epoch; the batch a multiple of
``batch_multiple()`` (the data-parallel ranks) and the predict buckets
doubling from ``predict_multiple()`` (the same, but 1 for the BiLSTM,
as the reference's); the lr schedule over
``schedule_total_epochs`` when given and checkpoint resume under
``checkpoint_dir`` (``loop_ckpt``, ref :147, :181-183); ``predict``
returns each sentence's per-token tag distributions, cut to its length,
from batches padded to a power of two; ``dump_parameters`` the
reference's flat names plus ``_meta/tag_names_json``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..model import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from ..model.base import BaseModel, Params
from ..model.bridge import dense_from_jax, dense_to_jax, overlay_params
from ..model.dataset import hash_token_ids, load_corpus_dataset
from ..model.logger import logger
from ..model.loop_ckpt import (LoopCheckpointer, TrainState, epoch_rng,
                               schedule_epochs)
from ..model.optim import ScheduledOptimizer, scheduled_adam
from ..parallel.data import group_mesh, mesh_apply, sum_grads
from ..parallel.mesh import Mesh
from ..torchenv import DeviceLike, resolve_device
from .layers import Dense, Embed, lecun_normal_

#: Sentences a predict forward takes at once; each chunk is padded to a
#: power of two.
PREDICT_CHUNK = 1024


class _CorpusTagger(BaseModel):
    """A token tagger over corpus datasets. Subclasses give
    ``create_module(n_tags)``, ``logits(net, ids, lengths, step)`` and
    ``create_optimizer(params, total_steps)``."""

    default_max_len = 64
    default_batch_size = 32
    default_max_epochs = 10

    def __init__(self, *, device: DeviceLike = None, **knobs: Any):
        super().__init__(**knobs)
        self.device = resolve_device(device)
        self._net: Optional[nn.Module] = None
        self._meta: Dict[str, Any] = {}

    # --- Subclass API ---

    def create_module(self, n_tags: int) -> nn.Module:
        raise NotImplementedError

    def logits(self, net: nn.Module, ids: torch.Tensor,
               lengths: torch.Tensor,
               step: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, max_len) int64 ids -> (B, max_len, n_tags) f32 logits;
        ``step`` (a device int64 scalar) is given in training only."""
        raise NotImplementedError

    def create_optimizer(self, params, total_steps: int
                         ) -> ScheduledOptimizer:
        raise NotImplementedError

    def train_logits(self, net: nn.Module, ids: torch.Tensor,
                     lengths: torch.Tensor, step: torch.Tensor):
        """(logits, a term to add to the loss or None) for a train
        step; by default ``logits`` and no term."""
        return self.logits(net, ids, lengths, step), None

    def batch_multiple(self) -> int:
        """What a batch's size must be a multiple of: a model split over
        data-parallel ranks gives their count."""
        return 1

    def predict_multiple(self) -> int:
        """The smallest predict bucket; buckets double from it."""
        return self.batch_multiple()

    # --- Plumbing ---

    @property
    def max_len(self) -> int:
        return int(self.knobs.get("max_len", self.default_max_len))

    def _encode(self, sentences: List[List[str]]):
        vocab = int(self.knobs.get("vocab_size", 16384))
        ids = np.stack([hash_token_ids(s, vocab, self.max_len)
                        for s in sentences])
        lengths = np.asarray([min(len(s), self.max_len) for s in sentences],
                             np.int64)
        return ids.astype(np.int64), lengths

    def _new_net(self, tag_names: List[str]) -> nn.Module:
        self._meta = {"tag_names": list(tag_names)}
        return self.create_module(len(tag_names)).to(self.device)

    def _require_net(self) -> nn.Module:
        if self._net is None:
            raise RuntimeError("train() or load_parameters() first")
        return self._net

    # --- BaseModel ---

    def train(self, dataset_path: str, *,
              shared_params: Optional[Params] = None, **kwargs: Any) -> None:
        ds = load_corpus_dataset(dataset_path)
        net = self._new_net(ds.tag_names)
        if shared_params is not None:
            overlay_params(net, shared_params)
        ids, lengths = self._encode(ds.sentences)
        tags = np.zeros((ds.size, self.max_len), np.int64)
        for i, t in enumerate(ds.tags):
            tags[i, :min(len(t), self.max_len)] = t[:self.max_len]
        dev = self.device
        ids_d = torch.from_numpy(ids).to(dev)
        len_d = torch.from_numpy(lengths).to(dev)
        tags_d = torch.from_numpy(tags).to(dev)

        batch_size = max(1, min(int(self.knobs.get(
            "batch_size", self.default_batch_size)), ds.size))
        # Rounded to the data-parallel ranks (the transformer's :542).
        mult = self.batch_multiple()
        batch_size = max(mult, (batch_size // mult) * mult)
        max_epochs = int(self.knobs.get("max_epochs",
                                        self.default_max_epochs))
        if self.knobs.get("quick_train", False):
            max_epochs = min(max_epochs,
                             int(self.knobs.get("trial_epochs", 1)))
        steps = max(1, ds.size // batch_size)
        opt = self.create_optimizer(list(net.parameters()),
                                    steps * schedule_epochs(kwargs,
                                                            max_epochs))
        seed = int(self.knobs.get("seed", 0))
        step_t = torch.zeros((), dtype=torch.int64, device=dev)
        cols = torch.arange(self.max_len, device=dev)
        logger.define_plot("Training", ["loss", "token_acc"],
                           x_axis="epoch")
        # Checkpoint resume (ref :181-183; the transformer's :631): the
        # state, with the step counter that the dropout draws hash.
        ckpt = LoopCheckpointer(kwargs)
        state = TrainState(net, opt, step_t) if ckpt.enabled else None
        start_epoch = ckpt.restore(state)[0] if state is not None else 0
        last_epoch = None
        net.train()
        for epoch in range(start_epoch, max_epochs):
            order = epoch_rng(seed, epoch).permutation(ds.size)
            if steps * batch_size > ds.size:
                order = np.resize(order, steps * batch_size)
            order_d = torch.from_numpy(
                order[:steps * batch_size].reshape(steps, batch_size)).to(dev)
            sums = torch.zeros(2, dtype=torch.float32, device=dev)
            for s in range(steps):
                sel = order_d[s]
                opt.zero_grad()
                out, extra = self.train_logits(net, ids_d[sel], len_d[sel],
                                               step_t)
                mask = (cols[None, :] < len_d[sel][:, None]).float()
                y = tags_d[sel]
                losses = F.cross_entropy(out.transpose(1, 2), y,
                                         reduction="none")
                n = torch.clamp_min(mask.sum(), 1.0)
                loss = (losses * mask).sum() / n
                if extra is not None:
                    loss = loss + extra
                loss.backward()
                sum_grads(self.mesh, net.parameters())
                opt.step()
                acc = ((out.detach().argmax(-1) == y).float() * mask).sum() / n
                sums += torch.stack([loss.detach(), acc])
                step_t += 1
            means = (sums / steps).tolist()
            logger.log(epoch=epoch, loss=means[0], token_acc=means[1])
            last_epoch = epoch
            if state is not None:
                ckpt.after_epoch(epoch, state, max_epochs)
        if state is not None:
            ckpt.after_loop(last_epoch, state)
        net.eval()
        self._net = net

    @torch.no_grad()
    def predict_probs(self, sentences: List[List[str]]) -> np.ndarray:
        """(n, max_len, n_tags) f32 probabilities, in chunks of up to
        ``PREDICT_CHUNK`` sentences, each padded with all-``PAD_ID``
        rows (length 1 for the BiLSTM, as the reference pads) to a power
        of two; the padding rows are sliced off."""
        net = self._require_net()
        ids, lengths = self._encode(sentences)
        out = []
        for s in range(0, len(sentences), PREDICT_CHUNK):
            chunk, lens = ids[s:s + PREDICT_CHUNK], lengths[s:s + PREDICT_CHUNK]
            n = chunk.shape[0]
            bucket = self.predict_multiple()
            while bucket < n:
                bucket *= 2
            if n < bucket:
                chunk = np.concatenate(
                    [chunk, np.zeros((bucket - n, chunk.shape[1]),
                                     chunk.dtype)])
                lens = np.concatenate([lens, np.ones((bucket - n,),
                                                     lens.dtype)])
            logits = self.logits(net, torch.from_numpy(chunk).to(self.device),
                                 torch.from_numpy(lens).to(self.device))
            out.append(torch.softmax(logits.float(), -1)[:n].cpu().numpy())
        return np.concatenate(out)

    def evaluate(self, dataset_path: str) -> float:
        ds = load_corpus_dataset(dataset_path)
        probs = self.predict_probs(ds.sentences)
        n_correct = n_total = 0
        for i, gold in enumerate(ds.tags):
            length = min(len(gold), self.max_len)
            pred = probs[i, :length].argmax(-1)
            n_correct += int((pred == np.asarray(gold[:length])).sum())
            n_total += length
        return n_correct / max(n_total, 1)

    def predict(self, queries: List[Any]) -> List[Any]:
        """Queries are token lists; each answer is the list of per-token
        tag distributions up to the sentence's length (cut to
        ``max_len``), which the predictor's ensemble averages."""
        self._require_net()
        if not queries:
            return []
        sentences = [list(q) for q in queries]
        probs = self.predict_probs(sentences)
        return [probs[i, :min(len(s), self.max_len)].tolist()
                for i, s in enumerate(sentences)]

    def dump_parameters(self) -> Params:
        out = dense_to_jax(self._require_net().state_dict())
        out["_meta/tag_names_json"] = np.frombuffer(
            json.dumps(self._meta["tag_names"]).encode(), np.uint8)
        return out

    def load_parameters(self, params: Params) -> None:
        blob = params.get("_meta/tag_names_json")
        if blob is None:
            raise ValueError("params missing _meta/tag_names_json")
        net = self._new_net(json.loads(np.asarray(blob).tobytes().decode()))
        net.load_state_dict(dense_from_jax(params))
        self._net = net.eval()

    def destroy(self) -> None:
        self._net = None


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """flax's ``flip_sequences`` on (B, T, ...) ``x``: position ``t`` takes
    ``(T − 1 − t + length) mod T``, so each row reverses within its
    length and its padding reverses within itself (an involution)."""
    t = x.shape[1]
    idx = (torch.arange(t - 1, -1, -1, device=x.device)[None, :]
           + lengths[:, None]) % t
    idx = idx.view(*idx.shape, *([1] * (x.dim() - 2))).expand_as(x)
    return torch.gather(x, 1, idx)


class _LSTMCell(nn.LSTMCell):
    """``nn.LSTMCell`` initialised as flax's ``OptimizedLSTMCell``:
    LeCun-normal input kernels, orthogonal recurrent kernels, zero
    biases (``bias_ih`` stays zero and untrained: flax has no input
    bias)."""

    def __init__(self, in_features: int, hidden: int, gen: torch.Generator):
        super().__init__(in_features, hidden)
        with torch.no_grad():
            for w in self.weight_ih.split(hidden):
                lecun_normal_(w, in_features, gen)
            for w in self.weight_hh.split(hidden):
                nn.init.orthogonal_(w, generator=gen)
            self.bias_ih.zero_()
            self.bias_hh.zero_()
        self.bias_ih.requires_grad_(False)

    def scan(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> (B, T, hidden): the cell over every position
        from a zero carry, as one ``torch.lstm``."""
        zeros = x.new_zeros((1, x.shape[0], self.hidden_size))
        out, _, _ = torch.lstm(
            x, (zeros, zeros),
            [self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh],
            True, 1, 0.0, self.training, False, True)
        return out


class _BiLstm(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, hidden: int,
                 n_tags: int, seed: int):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.Embed_0 = Embed(vocab_size, embed_dim, gen)
        self.OptimizedLSTMCell_0 = _LSTMCell(embed_dim, hidden, gen)
        self.OptimizedLSTMCell_1 = _LSTMCell(embed_dim, hidden, gen)
        self.Dense_0 = Dense(2 * hidden, n_tags, gen, f32=True)

    def forward(self, ids: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        x = self.Embed_0(ids)
        fwd = self.OptimizedLSTMCell_0.scan(x)
        bwd = flip_sequences(
            self.OptimizedLSTMCell_1.scan(flip_sequences(x, lengths)),
            lengths)
        return self.Dense_0(torch.cat([fwd, bwd], dim=-1))


class TorchPosTagger(_CorpusTagger):
    """BiLSTM token tagger over corpus datasets (POS_TAGGING)."""

    @staticmethod
    def get_knob_config():
        return {
            "embed_dim": IntegerKnob(16, 128),
            "hidden": IntegerKnob(16, 128),
            "learning_rate": FloatKnob(1e-3, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([16, 32, 64]),
            "max_epochs": IntegerKnob(3, 20),
            "max_len": FixedKnob(64),
            "vocab_size": FixedKnob(16384),
            "seed": FixedKnob(0),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        self._mesh: Optional[Mesh] = None

    @property
    def mesh(self) -> Mesh:
        """The data-parallel mesh over the devices of the group bound to
        the thread, or over the model's device alone (ref :83-86)."""
        if self._mesh is None:
            self._mesh = group_mesh(self.device)
        return self._mesh

    def batch_multiple(self) -> int:
        return self.mesh.shape["dp"]

    def predict_multiple(self) -> int:
        # Powers of two from 1, as the reference's (ref :250-252).
        return 1

    def create_module(self, n_tags: int) -> nn.Module:
        return _BiLstm(int(self.knobs.get("vocab_size", 16384)),
                       int(self.knobs.get("embed_dim", 64)),
                       int(self.knobs.get("hidden", 64)), n_tags,
                       seed=int(self.knobs.get("seed", 0)))

    def logits(self, net, ids, lengths, step=None):
        """On the model's device, or each dp rank's rows through its
        replica of ``net`` on its device (ref :160-180), the logits
        gathered here."""
        if self.mesh.size == 1:
            return net(ids, lengths)
        return mesh_apply(
            self.mesh, net, ids.shape[0],
            lambda dev, lo, hi: (ids[lo:hi].to(dev, non_blocking=True),
                                 lengths[lo:hi].to(dev, non_blocking=True)),
            self.device)

    def create_optimizer(self, params, total_steps: int):
        """``optax.adam(cosine_decay_schedule(lr, total, alpha=0.01))``
        (ref :147-148)."""
        return scheduled_adam(params,
                              float(self.knobs.get("learning_rate", 1e-2)),
                              total_steps)
