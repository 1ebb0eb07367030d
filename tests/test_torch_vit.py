"""``TorchViT`` against ``JaxViT`` on the CPU.

Weights come from the JAX side through the bridge (``dense_from_jax``),
with ``cls``, the norms' scales and biases jittered so that a test sees
them (``pos_embed`` starts from flax's normal(0.02), non-zero, so a
patch order that put it on the wrong tokens would show). Size: d_model
32, 2 heads of 16, patch 4 on 16×16×3 images (17 tokens), the depth mask
at 3 of 6 blocks. Both sides attend with ``default_attention``: the
blockwise formulation on the CPU.

Tolerances. In float32 (flax's ``dtype`` and the port's
``layers.COMPUTE``) logits within 1e-5 (measured 1.1e-6). In bf16 both
round each product to bf16 after summing in another order, so a logit
may land on a neighbouring bf16 value through the six blocks: 2^-5, two
ulps of a logit below 4 (measured 1.1e-2). One train step (Adam with
the weight decay coupled into the moments, f32): the loss within 1e-5
and each tensor's update within 1e-3 of its size. int8 serving: the
reference's envelope, 2e-2 on probabilities. Stacked members against
their own predict: 1e-5 (f32 sums in another order under vmap).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from rafiki_torch.datasets import make_synthetic_image_dataset
from rafiki_torch.model.bridge import dense_from_jax, dense_to_jax
from rafiki_torch.model.logger import logger as torch_logger
from rafiki_torch.model.stacked import StackedMembers, stack_members
from rafiki_torch.models import TorchViT, layers
from rafiki_torch.models import vit as tvit
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.models.vit import JaxViT, _ViT
from rafiki_tpu.parallel.mesh import build_mesh

SHAPE = (16, 16, 3)
N_CLASSES = 10
KNOBS = {"d_model": 32, "n_heads": 2, "patch": 4, "depth": 3}
DEPTH = (np.arange(6) < 3).astype(np.float32)
INT8_ATOL = 2e-2


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables, sep="/").items()}


def _unflat(flat):
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


@functools.lru_cache(maxsize=None)
def _init(seed=0):
    jm = _ViT(n_classes=N_CLASSES, d_model=32, n_heads=2, patch=4,
              n_tokens=17)
    flat = _flat(jm.init(jax.random.key(seed), jnp.zeros((1, *SHAPE))))
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith(("/scale", "/bias")) or k == "params/cls":
            flat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    assert np.abs(flat["params/pos_embed"]).max() > 0
    return flat


def _images(n=8, seed=1):
    return np.random.default_rng(seed).random((n, *SHAPE)).astype(
        np.float32)


def _port(flat):
    net = tvit._ViT(3, N_CLASSES, 32, 2, 4, 17, seed=0)
    net.load_state_dict(dense_from_jax(flat))
    return net


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2 ** -5)])
def test_forward_matches_jax(monkeypatch, dtype, atol):
    monkeypatch.setattr(layers, "COMPUTE", getattr(torch, dtype))
    flat = _init()
    x = _images()
    jm = _ViT(n_classes=N_CLASSES, d_model=32, n_heads=2, patch=4,
              n_tokens=17, dtype=getattr(jnp, dtype))
    want = np.asarray(jm.apply(_unflat(flat), jnp.asarray(x),
                               depth=jnp.asarray(DEPTH)), np.float32)
    got = _port(flat)(torch.from_numpy(x), torch.from_numpy(DEPTH))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol,
                               rtol=0)


def test_depth_mask_makes_a_block_the_identity():
    flat = _init()
    net = _port(flat)
    x = torch.from_numpy(_images(2))
    zero = torch.zeros(6)
    for i in range(6):
        getattr(net, f"_EncoderBlock_{i}").Dense_3.bias.data += 1.0
    a = net(x, zero)
    b = net(x, torch.from_numpy(DEPTH))
    assert not torch.equal(a, b)
    for i in range(3, 6):
        getattr(net, f"_EncoderBlock_{i}").Dense_3.bias.data += 5.0
    assert torch.equal(b, net(x, torch.from_numpy(DEPTH)))


def test_the_bridge_round_trip_is_exact():
    flat = _init()
    back = dense_to_jax(_port(flat).state_dict())
    assert set(back) == set(flat)
    for k in flat:
        assert np.array_equal(back[k], flat[k]), k


@pytest.fixture(scope="module")
def one_batch(tmp_path_factory):
    return make_synthetic_image_dataset(
        str(tmp_path_factory.mktemp("vit")), n_train=16, n_val=16,
        image_shape=SHAPE, n_classes=N_CLASSES, seed=0)


def _train(logger, model, path, shared):
    recs = []
    prior = logger.current_sink()
    logger.set_sink(recs.append)
    try:
        model.train(path, shared_params=shared)
    finally:
        logger.set_sink(prior)
    return [r["values"] for r in recs
            if r["type"] == "values" and "epoch" in r.get("values", {})]


class _JaxViT32(JaxViT):
    def create_module(self, n_classes, image_shape):
        return super().create_module(n_classes, image_shape).clone(
            dtype=jnp.float32)


def test_one_train_step_matches_jax(one_batch, monkeypatch):
    """16 images, batch 16: one step of Adam with the weight decay knob
    coupled into the moments (``traced_hyperparam_optimizer(opt="adam",
    weight_decay=True)``), from the same parameters, in f32."""
    monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    start = _init(2)
    knobs = dict(KNOBS, learning_rate=3e-3, weight_decay=1e-2,
                 batch_size=16, max_epochs=1, early_stop_epochs=0)
    jm = _JaxViT32(**knobs)
    tm = TorchViT(device="cpu", **knobs)
    jrec = _train(jax_logger, jm, one_batch[0], start)
    trec = _train(torch_logger, tm, one_batch[0], start)
    assert len(jrec) == len(trec) == 1
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 1e-5
    a = {k: np.asarray(v) for k, v in jm.dump_parameters().items()}
    b = tm.dump_parameters()
    assert set(a) == set(b)
    for k in start:
        step = np.linalg.norm(a[k] - start[k])
        assert step > 0, k
        assert np.linalg.norm(b[k] - a[k]) <= 1e-3 * step, k


def test_the_optimizer_reads_the_reference_defaults():
    """Without the knobs, the learning rate and weight decay are
    ``traced_knob_defaults``' (1e-3 and 1e-4), as the reference's."""
    tm = TorchViT(device="cpu")
    p = torch.nn.Parameter(torch.zeros(3))
    opt = tm.create_optimizer([p], 2, 1)
    assert opt.peak_lr == pytest.approx(1e-3)
    assert opt.opt.param_groups[0]["weight_decay"] == pytest.approx(1e-4)
    assert isinstance(opt.opt, torch.optim.Adam)
    assert not isinstance(opt.opt, torch.optim.AdamW)


def _pair(seed, **over):
    knobs = dict(KNOBS, **over)
    p = dict(_init(seed))
    p["_meta/n_classes"] = np.asarray(N_CLASSES)
    p["_meta/image_shape"] = np.asarray(SHAPE)
    jm = JaxViT(**knobs)
    jm._mesh = build_mesh(jax.devices()[:1])
    jm.load_parameters(p)
    tm = TorchViT(device="cpu", **knobs)
    tm.load_parameters(p)
    return jm, tm


def test_predict_matches_jax():
    jm, tm = _pair(0)
    q = (_images(5, 3) * 255).astype(np.uint8)
    np.testing.assert_allclose(np.asarray(tm.predict(list(q))),
                               np.asarray(jm.predict(list(q))),
                               atol=3.9e-3, rtol=0)


def test_quantized_apply_matches_the_reference():
    jm, tm = _pair(0)
    rj, rt = jm.enable_serving_quant("int8"), tm.enable_serving_quant("int8")
    assert rj["layers"] == rt["layers"]
    assert rt["layers"]["params/Conv_0/kernel"] == "int8"
    q = (_images(5, 4) * 255).astype(np.uint8)
    got = np.asarray(tm.predict(list(q)))
    np.testing.assert_allclose(got, np.asarray(jm.predict(list(q))),
                               atol=INT8_ATOL, rtol=0)
    assert tm.quantized_apply(*tm._quant_device_arrays()[:3],
                              torch.from_numpy(_images(2)),
                              tm._extra_dev()) is not None


@pytest.mark.parametrize("quant", [None, "int8"])
def test_stacked_members_match_each_member(quant):
    """Two members of different depths stack (the supernet is one); each
    member's stacked rows are its own predict."""
    ms = [_pair(0)[1], _pair(1, depth=5)[1]]
    if quant:
        for m in ms:
            m.enable_serving_quant(quant)
    st = stack_members(ms)
    assert isinstance(st, StackedMembers)
    q = (_images(3, 5) * 255).astype(np.uint8)
    bucket = st.predict_bucket(3, q.dtype)
    buf = np.zeros((bucket, *SHAPE), np.uint8)
    buf[:3] = q
    fins = st.member_finishers([st.staged_submit(buf, 3)])
    for i, m in enumerate(ms):
        np.testing.assert_allclose(np.asarray(fins[i]()), m.predict_proba(q),
                                   atol=1e-5, rtol=0)


def test_parameter_files_interchange():
    """A reference-written file loads into the port and back."""
    jm, _ = _pair(3)
    p = {k: np.asarray(v) for k, v in jm.dump_parameters().items()}
    tm = TorchViT(device="cpu", **KNOBS)
    tm.load_parameters(p)
    back = tm.dump_parameters()
    assert set(back) == set(p)
    for k in p:
        assert np.array_equal(np.asarray(back[k]), p[k]), k
