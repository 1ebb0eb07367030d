"""Shared set-up of the transformer tagger's parallel-mode tests.

Both packages' taggers build their mesh from the group bound to the
thread. ``bound(n)`` binds ``n`` of the reference's 8 virtual CPU
devices and a port group of ``n`` CPU entries, so that both meshes have
the same shape. ``MODES`` are the parallelism tour's seven, on 4
entries; ``start_params`` draws a mode's parameters from the
reference's init (f32 or bf16), the norms jittered, and
``corpus``-style sets come from ``make_synthetic_corpus_dataset``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
from flax import traverse_util

from rafiki_torch.model.logger import logger as torch_logger
from rafiki_torch.parallel.chips import ChipGroup as TorchGroup
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.models.transformer import (JaxTransformerTagger,
                                           _TransformerTagger)
from rafiki_tpu.ops import default_attention as jax_attention
from rafiki_tpu.parallel.chips import ChipGroup as JaxGroup

BASE = {"d_model": 32, "n_heads": 4, "n_layers": 2, "max_len": 16,
        "vocab_size": 300, "dropout": 0.0}
N_TAGS = 5
ENTRIES = 4

MODES = {
    "dp": {},
    "sp_ring": {"sequence_parallel": 2},
    "sp_alltoall": {"sequence_parallel": 2, "sp_schedule": "alltoall"},
    "ep_moe": {"moe_experts": 4, "expert_parallel": 2},
    "pp": {"pipeline_parallel": 2},
    "pp_sp": {"pipeline_parallel": 2, "sequence_parallel": 2},
    "pp_ep": {"pipeline_parallel": 2, "moe_experts": 4,
              "expert_parallel": 2},
}


@contextlib.contextmanager
def bound(n=ENTRIES):
    JaxGroup(indices=tuple(range(n))).bind_to_thread()
    TorchGroup(indices=(0,) * n, device_type="cpu").bind_to_thread()
    try:
        yield
    finally:
        JaxGroup.unbind_thread()
        TorchGroup.unbind_thread()


def ids(seed=0, rows=8):
    rng = np.random.default_rng(seed)
    t = BASE["max_len"]
    out = rng.integers(1, BASE["vocab_size"], (rows, t))
    lengths = rng.integers(1, t + 1, rows)
    lengths[0] = t
    out[np.arange(t)[None, :] >= lengths[:, None]] = 0
    return out


def start_params(mode, seed=0, dtype=jnp.float32):
    """The reference module's init for ``mode`` (its MoE blocks when it
    has them), flattened, the norms jittered; float32 arrays."""
    module = _TransformerTagger(
        vocab_size=BASE["vocab_size"], d_model=BASE["d_model"],
        n_heads=BASE["n_heads"], n_layers=BASE["n_layers"], n_tags=N_TAGS,
        max_len=BASE["max_len"], dtype=dtype,
        moe_experts=int(MODES[mode].get("moe_experts", 0)))
    v = module.init(jax.random.key(seed), jnp.asarray(ids(seed)),
                    jax_attention(causal=False))
    flat = {k: np.asarray(x, np.float32) for k, x in
            traverse_util.flatten_dict({"params": v["params"]},
                                       sep="/").items()}
    rng = np.random.default_rng(seed)
    for k, x in flat.items():
        if k.endswith(("/scale", "/bias")) and "expert" not in k:
            flat[k] = (x + 0.1 * rng.standard_normal(x.shape)).astype(
                np.float32)
    return module, flat


def unflat(flat):
    return {"params": traverse_util.unflatten_dict(
        {k[len("params/"):]: jnp.asarray(v) for k, v in flat.items()
         if k.startswith("params/")}, sep="/")}


class JaxTagger32(JaxTransformerTagger):
    """The reference's tagger in float32 (flax's ``dtype``). Its
    pipeline path names bfloat16 itself; ``f32_pipeline`` makes that
    name float32 for a test."""

    def _ensure_module(self, n_tags):
        if self._module is None:
            super()._ensure_module(n_tags)
            self._module = self._module.clone(dtype=jnp.float32)


class _JnpF32:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


def f32_pipeline(monkeypatch):
    """The reference's pipelined forward (``_pp_logits_fn``, which reads
    ``jnp.bfloat16`` when called) in float32, for this test."""
    monkeypatch.setattr("rafiki_tpu.models.transformer.jnp", _JnpF32())


def train(logger, model, path, **kw):
    """``model.train(path, **kw)``; the epoch records it logged."""
    recs = []
    prior = logger.current_sink()
    logger.set_sink(recs.append)
    try:
        model.train(path, **kw)
    finally:
        logger.set_sink(prior)
    return [r["values"] for r in recs
            if r["type"] == "values" and "epoch" in r.get("values", {})]


__all__ = ["BASE", "ENTRIES", "JaxTagger32", "MODES", "N_TAGS", "bound",
           "f32_pipeline", "ids", "jax_logger", "start_params", "torch_logger", "train",
           "unflat"]
