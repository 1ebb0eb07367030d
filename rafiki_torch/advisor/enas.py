"""ENAS controller advisor: an LSTM policy trained with REINFORCE over
``ArchKnob`` encodings.

The port of ``rafiki_tpu/advisor/enas.py``. The controller
(``_Controller``, ref :33-64) rolls an LSTM of hidden 64 over the
architecture positions: its first input is the start token (the last
row of an ``Embedding(max_c + 1, 64)``), each later input the embedding
of the choice taken at the position before, and one ``Linear`` head per
position gives that position's logits, padded with −1e9 to ``max_c``.
It is built from ``nn.LSTMCell`` (the bridge maps flax's eight gate
``Dense`` layers onto its stacked weights; ``bias_ih`` stays zero and
out of the optimizer, since flax has no input-gate bias),
``nn.Embedding`` and ``nn.Linear``.

Sampling runs once over the positions, carrying the LSTM state: the
logits at position i depend only on the choices before it, so the draw
has the distribution of the reference's teacher-forced re-rolls
(:111-124). Draws come from a ``torch.Generator`` seeded from
``seed``, not from ``jax.random``. The update is the reference's
REINFORCE step (:126-133): loss ``−advantage · Σ log p(chosen) − 1e-3 ·
entropy`` under Adam (lr 3e-3, optax's defaults), the advantage taken
against a moving baseline of decay 0.7 (:186-197).

The rest follows the reference: search proposals ask for
``GLOBAL_RECENT`` shared parameters and switch on the SHARE_PARAMS,
QUICK_TRAIN, QUICK_EVAL, EARLY_STOP and DOWNSCALE policies; the last
``final_train_frac`` of the budget (``_is_final``, counting forgotten
trials) retrains the best architecture from scratch (params type
``NONE``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..constants import ParamsType
from ..model.knobs import (ArchKnob, KnobConfig, Knobs, PolicyKnob,
                           sample_knobs)
from ..torchenv import DeviceLike, resolve_device
from .base import BaseAdvisor, Proposal

HIDDEN = 64
_SEARCH_POLICIES = ("SHARE_PARAMS", "QUICK_TRAIN", "QUICK_EVAL",
                    "EARLY_STOP", "DOWNSCALE")


class _Controller(nn.Module):
    """LSTM policy: one categorical head per architecture position."""

    def __init__(self, n_choices: Sequence[int], hidden: int = HIDDEN):
        super().__init__()
        self.n_choices = tuple(n_choices)
        self.max_c = max(self.n_choices)
        self.LSTMCell_0 = nn.LSTMCell(hidden, hidden)
        with torch.no_grad():
            self.LSTMCell_0.bias_ih.zero_()
        self.LSTMCell_0.bias_ih.requires_grad_(False)
        self.Embed_0 = nn.Embedding(self.max_c + 1, hidden)
        for i, c in enumerate(self.n_choices):
            self.add_module(f"head_{i}", nn.Linear(hidden, c))

    def _step(self, i: int, inp: torch.Tensor, state):
        h, c = self.LSTMCell_0(inp[None], state)
        logits = getattr(self, f"head_{i}")(h[0])
        pad = self.max_c - self.n_choices[i]
        return F.pad(logits, (0, pad), value=-1e9), (h, c)

    def _start(self):
        dev = self.Embed_0.weight.device
        zeros = torch.zeros(1, self.LSTMCell_0.hidden_size, device=dev)
        start = self.Embed_0(torch.tensor(self.max_c, device=dev))
        return start, (zeros, zeros)

    def forward(self, actions: torch.Tensor) -> torch.Tensor:
        """Teacher-forced pass: (n_pos,) choice indices -> (n_pos,
        max_c) logits."""
        inp, state = self._start()
        out = []
        for i in range(len(self.n_choices)):
            logits, state = self._step(i, inp, state)
            out.append(logits)
            inp = self.Embed_0(actions[i])
        return torch.stack(out)

    @torch.no_grad()
    def sample(self, gen: torch.Generator) -> np.ndarray:
        """Ancestral sampling in one pass: (n_pos,) choice indices."""
        inp, state = self._start()
        actions = []
        for i in range(len(self.n_choices)):
            logits, state = self._step(i, inp, state)
            a = torch.multinomial(torch.softmax(logits, -1), 1,
                                  generator=gen)[0]
            actions.append(a)
            inp = self.Embed_0(a)
        return torch.stack(actions).cpu().numpy()


class EnasAdvisor(BaseAdvisor):
    """Architecture search over the config's single ``ArchKnob``. The
    controller runs on ``device`` (the card unless the caller asks for
    the CPU)."""

    def __init__(self, knob_config: KnobConfig, seed: int = 0,
                 total_trials: Optional[int] = None,
                 final_train_frac: float = 0.15,
                 lr: float = 3e-3, entropy_weight: float = 1e-3,
                 baseline_decay: float = 0.7, device: DeviceLike = None):
        super().__init__(knob_config, seed, total_trials=total_trials)
        arch_items = [(n, k) for n, k in knob_config.items()
                      if isinstance(k, ArchKnob)]
        if len(arch_items) != 1:
            raise ValueError("EnasAdvisor needs exactly one ArchKnob")
        self.arch_name, self.arch_knob = arch_items[0]
        self.positions = self.arch_knob.positions
        self.final_train_frac = final_train_frac
        self.entropy_weight = entropy_weight
        self.baseline: Optional[float] = None
        self.baseline_decay = baseline_decay
        self._policies = {n for n, k in knob_config.items()
                          if isinstance(k, PolicyKnob)}
        # trial_no -> sampled action indices (None for final-phase trials);
        # entries are popped by _observe, or _forget for errored trials.
        self._pending_meta: Dict[int, Optional[np.ndarray]] = {}
        self._choice_values = [list(p) for p in self.positions]

        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = _Controller([len(p) for p in self.positions])
        self.model.to(self.device)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self._opt = torch.optim.Adam(
            [p for p in self.model.parameters() if p.requires_grad],
            lr=lr, betas=(0.9, 0.999), eps=1e-8)

    # --- Phase split ---

    def _is_final(self, trial_no: int) -> bool:
        if not self.total_trials:
            return False
        n_final = max(1, int(self.total_trials * self.final_train_frac))
        # Effective position, not raw trial_no: forget() refunds errored
        # trials' budget slots, and a refunded slot must resume the
        # exploration phase rather than landing in the final-retrain tail.
        effective = trial_no - self._forgotten
        return effective > self.total_trials - n_final

    # --- The controller ---

    def _actions(self, actions: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(actions, np.int64),
                               device=self.device)

    def _update(self, actions: np.ndarray, advantage: float) -> None:
        acts = self._actions(actions)
        logits = self.model(acts)
        logp = torch.log_softmax(logits, dim=-1)
        chosen = logp.gather(1, acts[:, None]).sum()
        entropy = -(torch.softmax(logits, dim=-1) * logp).sum()
        loss = -advantage * chosen - self.entropy_weight * entropy
        self._opt.zero_grad(set_to_none=True)
        loss.backward()
        self._opt.step()

    # --- BaseAdvisor hooks ---

    def _propose_knobs(self, trial_no: int) -> Knobs:
        knobs = sample_knobs(self.knob_config, self.rng)
        if self._is_final(trial_no) and self._best is not None:
            # Final phase: retrain the best architecture from scratch.
            knobs[self.arch_name] = list(self._best[0][self.arch_name])
            self._pending_meta[trial_no] = None  # no policy update
        else:
            idx = self.model.sample(self._gen)
            knobs[self.arch_name] = [self._choice_values[i][int(a)]
                                     for i, a in enumerate(idx)]
            self._pending_meta[trial_no] = idx
        return knobs

    def _fill_policies(self, knobs: Knobs, trial_no: int) -> Knobs:
        final = self._is_final(trial_no)
        for name in self._policies:
            if self.knob_config[name].policy in _SEARCH_POLICIES:
                knobs[name] = not final
            else:
                knobs.setdefault(name, False)
        return knobs

    def _params_type(self, trial_no: int) -> str:
        return ParamsType.NONE if self._is_final(trial_no) \
            else ParamsType.GLOBAL_RECENT

    def _observe(self, proposal: Proposal, score: float) -> None:
        idx = self._pending_meta.pop(proposal.trial_no, None)
        if idx is None:
            return
        if self.baseline is None:
            self.baseline = score
        adv = score - self.baseline
        self.baseline = (self.baseline_decay * self.baseline
                         + (1 - self.baseline_decay) * score)
        self._update(idx, adv)

    def _forget(self, proposal: Proposal) -> None:
        self._pending_meta.pop(proposal.trial_no, None)

    def arch_probs(self) -> np.ndarray:
        """Per-position choice probabilities under the current policy,
        each conditioned on the greedy choices before it."""
        with torch.no_grad():
            inp, state = self.model._start()
            probs = []
            for i in range(len(self.positions)):
                logits, state = self.model._step(i, inp, state)
                probs.append(torch.softmax(logits, -1))
                inp = self.model.Embed_0(logits.argmax())
            return torch.stack(probs).cpu().numpy()
