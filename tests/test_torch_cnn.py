"""``TorchCnn`` and ``dynamic_int8_conv`` against ``JaxCnn`` and the
reference's ``dynamic_int8_conv`` on the CPU.

Weights come from the JAX side through the bridge, biases jittered so
that they matter. Images 16×16×3 (stages at 16, 8 and 4 pixels, a flat
head input of 2×2×256). Tolerances: in float32 logits within 1e-4
(sums of up to 2,304 products in another order, logits below 10); in
bf16 2^-4, two bf16 ulps of a logit below 8 (the network's logits at
these weights reach 5). One train step in f32: the loss within 1e-5 and
each tensor's update within 1e-3 of its size. The int8 convolution's
int32 accumulators are equal exactly; its rescaled f32 output within
1e-6 relative. int8 serving: the reference's 2e-2 on probabilities.
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
from rafiki_torch.model.torch_model import dynamic_int8_conv, int8_conv
from rafiki_torch.models import TorchCnn, layers
from rafiki_torch.models import cnn as tcnn
from rafiki_tpu.model import jax_model as ref_jm
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.models.cnn import JaxCnn, _Cnn
from rafiki_tpu.parallel.mesh import build_mesh

SHAPE = (16, 16, 3)
N_CLASSES = 10


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables, sep="/").items()}


def _unflat(flat):
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


@functools.lru_cache(maxsize=None)
def _init(seed=0):
    flat = _flat(_Cnn(n_classes=N_CLASSES).init(
        jax.random.key(seed), jnp.zeros((1, *SHAPE))))
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("/bias"):
            flat[k] = (0.05 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return flat


def _images(n=6, seed=1):
    return np.random.default_rng(seed).random((n, *SHAPE)).astype(
        np.float32)


def _mask(sixteenths):
    return (np.arange(16) < sixteenths).astype(np.float32)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 2 ** -4)])
@pytest.mark.parametrize("sixteenths", [4, 16])
def test_forward_matches_jax(monkeypatch, dtype, atol, sixteenths):
    monkeypatch.setattr(layers, "COMPUTE", getattr(torch, dtype))
    flat = _init()
    x = _images()
    jm = _Cnn(n_classes=N_CLASSES, dtype=getattr(jnp, dtype))
    want = np.asarray(jm.apply(_unflat(flat), jnp.asarray(x),
                               width_16ths=jnp.asarray(_mask(sixteenths))))
    net = tcnn._Cnn(3, N_CLASSES, SHAPE[:2], seed=0)
    net.load_state_dict(dense_from_jax(flat))
    got = net(torch.from_numpy(x), torch.from_numpy(_mask(sixteenths)))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol,
                               rtol=0)


def test_the_bridge_round_trip_is_exact():
    flat = _init()
    net = tcnn._Cnn(3, N_CLASSES, SHAPE[:2], seed=0)
    net.load_state_dict(dense_from_jax(flat))
    back = dense_to_jax(net.state_dict())
    assert set(back) == set(flat)
    for k in flat:
        assert np.array_equal(back[k], flat[k]), k


@pytest.fixture(scope="module")
def one_batch(tmp_path_factory):
    return make_synthetic_image_dataset(
        str(tmp_path_factory.mktemp("cnn")), n_train=16, n_val=16,
        image_shape=SHAPE, n_classes=N_CLASSES, seed=0)


class _JaxCnn32(JaxCnn):
    def create_module(self, n_classes, image_shape):
        return super().create_module(n_classes, image_shape).clone(
            dtype=jnp.float32)


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


def test_one_train_step_matches_jax(one_batch, monkeypatch):
    """Batch 16, one step, width 12/16, Adam with coupled weight decay,
    f32 on both sides."""
    monkeypatch.setattr(layers, "COMPUTE", torch.float32)
    start = _init(1)
    knobs = {"width_16ths": 12, "learning_rate": 3e-3, "weight_decay": 1e-2,
             "batch_size": 16, "max_epochs": 1, "early_stop_epochs": 0}
    jm = _JaxCnn32(**knobs)
    tm = TorchCnn(device="cpu", **knobs)
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


@pytest.mark.parametrize("case", [
    ((2, 8, 8, 5), (3, 3, 5, 7), (1, 1), ((1, 1), (1, 1))),  # the CNN's
    ((3, 16, 16, 3), (4, 4, 3, 32), (4, 4), "VALID"),        # ViT's patches
    ((2, 4, 4, 256), (3, 3, 256, 8), (1, 1), ((1, 1), (1, 1))),  # k = 2304
    ((2, 9, 9, 4), (3, 3, 4, 6), (2, 2), "SAME"),
])
def test_dynamic_int8_conv_matches_the_reference(case):
    xs, ws, strides, padding = case
    rng = np.random.default_rng(0)
    xq = rng.integers(-127, 128, xs).astype(np.int8)
    wq = rng.integers(-127, 128, ws).astype(np.int8)
    acc = int8_conv(torch.from_numpy(xq), torch.from_numpy(wq), strides,
                    padding)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), strides, padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    assert acc.dtype == torch.int32
    assert np.array_equal(acc.numpy(), want)
    x = rng.standard_normal(xs).astype(np.float32)
    x[0] *= 0.0  # an all-zero sample: its scale clamps at 1e-8
    scale = rng.uniform(0.001, 0.01, ws[-1]).astype(np.float32)
    got = dynamic_int8_conv(torch.from_numpy(x), torch.from_numpy(wq),
                            torch.from_numpy(scale), strides, padding)
    ref = np.asarray(ref_jm.dynamic_int8_conv(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale), strides,
        padding))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def _pair(seed, **over):
    knobs = {"width_16ths": 12, **over}
    p = dict(_init(seed))
    p["_meta/n_classes"] = np.asarray(N_CLASSES)
    p["_meta/image_shape"] = np.asarray(SHAPE)
    jm = JaxCnn(**knobs)
    jm._mesh = build_mesh(jax.devices()[:1])
    jm.load_parameters(p)
    tm = TorchCnn(device="cpu", **knobs)
    tm.load_parameters(p)
    return jm, tm


def test_quantized_apply_matches_the_reference():
    jm, tm = _pair(0)
    rj, rt = jm.enable_serving_quant("int8"), tm.enable_serving_quant("int8")
    assert rj["layers"] == rt["layers"] and rt["n_int8"] == 8
    q = (_images(5, 4) * 255).astype(np.uint8)
    np.testing.assert_allclose(np.asarray(tm.predict(list(q))),
                               np.asarray(jm.predict(list(q))),
                               atol=2e-2, rtol=0)


def test_members_of_two_widths_stack():
    from rafiki_torch.model.stacked import stack_members

    ms = [_pair(0)[1], _pair(1, width_16ths=4)[1]]
    st = stack_members(ms)
    assert st is not None
    q = (_images(3, 5) * 255).astype(np.uint8)
    buf = np.zeros((st.predict_bucket(3, q.dtype), *SHAPE), np.uint8)
    buf[:3] = q
    fins = st.member_finishers([st.staged_submit(buf, 3)])
    for i, m in enumerate(ms):
        np.testing.assert_allclose(np.asarray(fins[i]()), m.predict_proba(q),
                                   atol=1e-5, rtol=0)
