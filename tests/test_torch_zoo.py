"""The conv zoo of the port (``TorchDenseNet``, ``TorchEnas`` and their
layers, bridge, optimizers and augmentation) against the JAX package on
the CPU.

The same numpy inputs go through both; weights are carried across by
the bridge (``dense_from_jax``), never drawn twice from seeds. The JAX
side runs on the 8-device CPU mesh of ``tests/conftest.py``, so train
batches are multiples of 8. Sizes: DenseNet's ``densenet_tiny`` preset
(blocks 2/2/2) with growth 8, and ``TinyEnas`` (2 blocks, 3 cells of 8
channels) on both sides, on 32×32×3 images.

Tolerances, each from bf16 rounding. Both packages convolve in bf16
with f32 sums, in different orders, so an activation may land on a
neighbouring bf16 value; one bf16 ulp of a logit below 2 is 2^-7 and
below 4 is 2^-6. ``LOGIT_ATOL`` allows two ulps of a logit below 4
(measured: one ulp). The BatchNorm layer alone, on one f32 input, is
held within 1e-6 (f32 rounding); its running variance after one step
differs by 0.1·var/(n − 1) if it took the unbiased variance, 8e-4·var
at the n = 128 of that test. Through the network a BatchNorm's input
carries the bf16 differences of the convolutions before it: the first
one's running statistics stay within 1e-5, the deepest within
``STATS_ATOL`` (measured 1.4e-4). Training parity is in
``tests/test_torch_zoo_train.py``.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util

from rafiki_tpu.model import jax_model
from rafiki_tpu.model.knobs import FixedKnob as JaxFixedKnob
from rafiki_tpu.model.logger import logger as jax_logger
from rafiki_tpu.models.densenet import JaxDenseNet, _DenseNet
from rafiki_tpu.models.enas import JaxEnas, _EnasNet
from rafiki_tpu.store import ParamStore as JaxParamStore
from rafiki_torch.datasets import make_synthetic_image_dataset
from rafiki_torch.model import FixedKnob
from rafiki_torch.model.bridge import dense_from_jax, dense_to_jax
from rafiki_torch.model.logger import logger as torch_logger
from rafiki_torch.model.torch_model import (crop_flip, crop_flip_draw,
                                           pad_crop_flip)
from rafiki_torch.models import TorchDenseNet, TorchEnas
from rafiki_torch.models import densenet as tdensenet
from rafiki_torch.models import enas as tenas
from rafiki_torch.models.layers import (BatchNorm, GroupNorm, avg_pool3,
                                        max_pool3)
from rafiki_torch.store import ParamStore

SHAPE = (32, 32, 3)
N_CLASSES = 10
TINY = (2, 2, 2)
GROWTH = 8
LOGIT_ATOL = 2 ** -5
STATS_ATOL = 3e-4
PROB_ATOL = 3.9e-3


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables, sep="/").items()}


def _jittered(flat, seed=0):
    """Non-trivial norm scales, biases and running statistics, so that
    a parity test sees them."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for k, v in flat.items():
        if k.endswith("/scale"):
            out[k] = (1 + 0.1 * rng.standard_normal(v.shape))
        elif k.endswith("/bias"):
            out[k] = 0.1 * rng.standard_normal(v.shape)
        elif k.endswith("/mean"):
            out[k] = 0.1 * rng.standard_normal(v.shape)
        elif k.endswith("/var"):
            out[k] = 1 + 0.2 * rng.random(v.shape)
        out[k] = np.asarray(out[k], np.float32)
    return out


def _images(n=16, seed=1):
    return np.random.default_rng(seed).random((n, *SHAPE)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _densenet_init(seed):
    jm = _DenseNet(block_config=TINY, growth_rate=GROWTH,
                   n_classes=N_CLASSES)
    return jm, _jittered(_flat(jm.init(jax.random.key(seed),
                                       jnp.zeros((1, *SHAPE)), train=False)),
                         seed)


def _densenet_pair(seed=0):
    """The reference module, its parameters (jittered) and the port's
    module loaded with them."""
    jm, flat = _densenet_init(seed)
    tm = tdensenet._DenseNet(3, TINY, GROWTH, N_CLASSES, seed=0)
    tm.load_state_dict(dense_from_jax(flat))
    return jm, dict(flat), tm


def _arch(seed, n_blocks=2):
    rng = np.random.default_rng(seed)
    a = []
    for _ in range(2):
        for b in range(n_blocks):
            a += [rng.integers(b + 2), rng.integers(5), rng.integers(b + 2),
                  rng.integers(5)]
    return np.asarray(a, np.int32).reshape(2, n_blocks, 4)


@functools.lru_cache(maxsize=None)
def _enas_init(seed):
    jm = _EnasNet(n_blocks=2, n_cells=3, channels=8, n_classes=N_CLASSES)
    return jm, _jittered(_flat(jm.init(jax.random.key(seed),
                                       jnp.zeros((1, *SHAPE)),
                                       arch=jnp.asarray(_arch(0)))), seed)


def _enas_pair(seed=0):
    jm, flat = _enas_init(seed)
    tm = tenas._EnasNet(3, 32, 2, 3, 8, N_CLASSES, seed=0)
    tm.load_state_dict(dense_from_jax(flat))
    return jm, dict(flat), tm


def _unflat(flat):
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


# --- (1) the bridge ---


@pytest.mark.parametrize("model", ["densenet", "enas"])
def test_bridge_round_trip_is_exact(model):
    _, flat, tm = (_densenet_pair if model == "densenet" else _enas_pair)()
    state = tm.state_dict()
    assert set(dense_from_jax(flat)) == set(state)
    back = dense_to_jax(state)
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].shape == flat[k].shape, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    if model == "densenet":
        assert flat["params/Conv_0/kernel"].shape == (3, 3, 3, 2 * GROWTH)
        assert tuple(state["Conv_0.weight"].shape) == (2 * GROWTH, 3, 3, 3)
        assert "batch_stats/_DenseLayer_0/BatchNorm_1/var" in flat
    else:
        dw = "c0_b0_s0_sep5/Conv_0"
        assert flat[f"params/{dw}/kernel"].shape == (5, 5, 1, 8)
        assert tuple(state[dw.replace("/", ".") + ".weight"].shape) == (
            8, 1, 5, 5)
        assert "params/stem_gn/scale" in flat and "params/head/bias" in flat


def test_bridge_rejects_unknown_layouts():
    with pytest.raises(ValueError, match="no port layout"):
        dense_from_jax({"params/x/kernel": np.zeros((2, 2, 2))})
    with pytest.raises(ValueError, match="no port layout"):
        dense_from_jax({"cache/x/mean": np.zeros(2)})
    with pytest.raises(ValueError, match="no reference layout"):
        dense_to_jax({"x.weight": torch.zeros(2, 2, 2)})


# --- (2) augmentation ---


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crop_flip_of_the_jax_draws_equals_pad_crop_flip_graph(seed):
    """Exact: both are gathers of the same pixels."""
    x = _images(8, seed)
    rng = jax.random.key(seed)
    r_y, r_x, r_f = jax.random.split(rng, 3)
    ys = np.array(jax.random.randint(r_y, (8,), 0, 9))
    xs = np.array(jax.random.randint(r_x, (8,), 0, 9))
    flip = np.array(jax.random.bernoulli(r_f, 0.5, (8,)))
    ref = np.asarray(jax_model.pad_crop_flip_graph(jnp.asarray(x), rng))
    out = crop_flip(torch.from_numpy(x), torch.from_numpy(ys).long(),
                    torch.from_numpy(xs).long(), torch.from_numpy(flip))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_small_images_pass_through_and_draws_are_stateless():
    step = torch.tensor(7)
    small = torch.rand(4, 12, 12, 1)
    assert pad_crop_flip(small, 1, step) is small
    ref = np.asarray(jax_model.pad_crop_flip_graph(
        jnp.asarray(small.numpy()), jax.random.key(0)))
    np.testing.assert_array_equal(small.numpy(), ref)
    ys, xs, flip = crop_flip_draw(1, step, 256)
    again = crop_flip_draw(1, step.clone(), 256)
    for a, b in zip((ys, xs, flip), again):
        assert torch.equal(a, b)
    assert int(ys.min()) == 0 and int(ys.max()) == 8
    assert int(xs.min()) == 0 and int(xs.max()) == 8
    assert 0.35 < float(flip.float().mean()) < 0.65
    other = crop_flip_draw(1, torch.tensor(8), 256)
    assert not torch.equal(ys, other[0])
    x = torch.rand(256, 32, 32, 3)
    assert torch.equal(pad_crop_flip(x, 1, step),
                       crop_flip(x, ys, xs, flip))


# --- (3) DenseNet and BatchNorm ---


def test_batchnorm_layer_matches_flax():
    """Output within 1e-6 (absolute and relative: f32 rounding of the
    same formula in two orders); the running variance is the biased
    one."""
    rng = np.random.default_rng(0)
    x = (0.5 + rng.standard_normal((8, 4, 4, 6))).astype(np.float32)
    bn = fnn.BatchNorm(momentum=0.9, dtype=jnp.float32)
    v = bn.init(jax.random.key(0), jnp.asarray(x), use_running_average=False)
    scale = (1 + 0.1 * rng.standard_normal(6)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(6)).astype(np.float32)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": v["batch_stats"]}
    y, upd = bn.apply(v, jnp.asarray(x), use_running_average=False,
                      mutable=["batch_stats"])
    tb = BatchNorm(6)
    tb.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.zeros(6),
                        "running_var": torch.ones(6)})
    out = tb(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y), atol=1e-6, rtol=1e-6)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   atol=1e-6, rtol=0)
    tb.eval()
    ye = bn.apply({"params": v["params"], "batch_stats": upd["batch_stats"]},
                  jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(
        tb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).detach().numpy(), np.asarray(ye), atol=1e-6,
        rtol=1e-6)


def test_groupnorm_layer_matches_flax():
    """flax's eps 1e-6 (torch's default 1e-5 would be off by 1e-3 here)."""
    rng = np.random.default_rng(1)
    x = (1e-3 * rng.standard_normal((2, 4, 4, 8))).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=4, dtype=jnp.float32)
    v = gn.init(jax.random.key(0), jnp.asarray(x))
    y = gn.apply(v, jnp.asarray(x))
    out = GroupNorm(4, 8)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y), atol=1e-5, rtol=1e-5)


def test_densenet_forward_matches_jax():
    jm, flat, tm = _densenet_pair()
    x = _images(16)
    yj, upd = jm.apply(_unflat(flat), jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    tm.train()
    yt = tm(torch.from_numpy(x))
    assert yt.dtype == torch.bfloat16 and yt.shape == (16, N_CLASSES)
    np.testing.assert_allclose(yt.float().detach().numpy(),
                               np.asarray(yj, np.float32), atol=LOGIT_ATOL,
                               rtol=0)
    new = {"batch_stats/" + k: np.asarray(v) for k, v in
           traverse_util.flatten_dict(upd["batch_stats"], sep="/").items()}
    ours = dense_to_jax(tm.state_dict())
    assert set(new) == {k for k in ours if k.startswith("batch_stats/")}
    first = "batch_stats/_DenseLayer_0/BatchNorm_0/"
    for k in new:
        tol = 1e-5 if k.startswith(first) else STATS_ATOL
        np.testing.assert_allclose(ours[k], new[k], atol=tol, rtol=0,
                                   err_msg=k)
    # Eval mode: both on the updated running statistics.
    flat2 = {**flat, **new}
    tm.load_state_dict(dense_from_jax(flat2))
    tm.eval()
    ye = jm.apply(_unflat(flat2), jnp.asarray(x), train=False)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).float().numpy(),
                                   np.asarray(ye, np.float32),
                                   atol=LOGIT_ATOL, rtol=0)


# --- (4) ENAS ---


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_enas_supernet_matches_jax_and_its_single_path(seed):
    jm, flat, tm = _enas_pair()
    x = _images(8)
    arch = _arch(seed)
    yj = jm.apply(_unflat(flat), jnp.asarray(x), arch=jnp.asarray(arch))
    with torch.no_grad():
        yt = tm(torch.from_numpy(x), arch=torch.from_numpy(arch))
        single = tenas._EnasNet(3, 32, 2, 3, 8, N_CLASSES, seed=0,
                                fixed_arch=tuple(arch.reshape(-1).tolist()))
        own = single.state_dict()
        assert set(own) < set(tm.state_dict())
        single.load_state_dict({k: v for k, v in tm.state_dict().items()
                                if k in own})
        ys = single(torch.from_numpy(x))
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               atol=LOGIT_ATOL, rtol=0)
    # Exact: the supernet takes the chosen branch's own values.
    assert torch.equal(yt, ys)


def test_enas_reduction_cells_and_calibration_strides():
    net = tenas._EnasNet(3, 32, 4, 6, 32, N_CLASSES, seed=0)
    assert net.reduce_at == {2, 4}
    strides = {n: m.Conv_0.stride for n, m in net.named_children()
               if n.endswith(("_pre0", "_pre1"))}
    assert strides["c2_pre1"] == 2 and strides["c2_pre0"] == 2
    assert strides["c3_pre0"] == 2 and strides["c3_pre1"] == 1
    small = tenas._EnasNet(3, 32, 2, 3, 8, N_CLASSES, seed=0)
    assert small.reduce_at == {1, 2}
    assert small.c2_pre0.Conv_0.stride == 4


# --- (5) pools ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pools_match_flax_at_the_edges(dtype):
    """All-negative inputs: a max pool padded with zeros, or an average
    that skips the padding, would differ at every edge pixel. In bf16
    flax sums the window in bf16 (eight roundings of a partial sum below
    18) and torch in f32, so the averages may differ by a few bf16 ulps
    of the result (2^-7 each below 2): 2^-5."""
    rng = np.random.default_rng(2)
    x = (-1 - rng.random((2, 7, 9, 3))).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    xj = jnp.asarray(x, jd)
    xt = torch.from_numpy(x).to(td).permute(0, 3, 1, 2)
    ref_avg = fnn.avg_pool(xj, (3, 3), strides=(1, 1), padding="SAME")
    ref_max = fnn.max_pool(xj, (3, 3), strides=(1, 1), padding="SAME")
    tol = 1e-6 if dtype == "float32" else 2 ** -5
    for ref, out in ((ref_avg, avg_pool3(xt)), (ref_max, max_pool3(xt))):
        np.testing.assert_allclose(
            out.permute(0, 2, 3, 1).float().numpy(),
            np.asarray(ref, np.float32), atol=tol, rtol=0)


# --- (6) optimizers ---


def _opt_params(seed=3):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


@pytest.mark.parametrize("model", ["densenet", "enas"])
def test_sgd_chains_match_optax_over_50_steps(model):
    """Within 2e-6 of the parameters' scale after 50 steps (f32
    rounding of the same update in two orders)."""
    import optax

    steps_per_epoch, epochs = 10, 5
    knobs = ({"learning_rate": 0.1, "weight_decay": 3e-4}
             if model == "densenet" else {"learning_rate": 0.05})
    p0 = _opt_params()
    if model == "densenet":
        tx = JaxDenseNet(**knobs).create_optimizer(steps_per_epoch, epochs)
    else:
        tx = JaxEnas(**knobs).create_optimizer(steps_per_epoch, epochs)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    if model == "densenet":
        for name, value in knobs.items():
            state.hyperparams[name] = jnp.asarray(value, jnp.float32)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    cls = TorchDenseNet if model == "densenet" else TorchEnas
    opt = cls(device="cpu", **knobs).create_optimizer(
        list(tp.values()), steps_per_epoch, epochs)
    rng = np.random.default_rng(4)
    for _ in range(50):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k]), atol=2e-6, rtol=0)
        assert np.abs(np.asarray(jp[k]) - p0[k]).max() > 0.1


# --- (7) training ---


@pytest.fixture(scope="module")
def cifar_like(tmp_path_factory):
    return make_synthetic_image_dataset(
        str(tmp_path_factory.mktemp("zoo")), n_train=64, n_val=32,
        image_shape=SHAPE, n_classes=N_CLASSES, seed=0)


def _jax_cls(base, dtype="bfloat16", augment=True):
    """A test subclass: batch 16 and one epoch fixed, optionally flax's
    dtype float32 and augmentation set to identity."""

    class Jax(base):
        @classmethod
        def get_knob_config(cls):
            cfg = dict(base.get_knob_config())
            cfg.update(batch_size=JaxFixedKnob(16),
                       max_epochs=JaxFixedKnob(1))
            return cfg

        def create_module(self, n_classes, image_shape):
            return super().create_module(n_classes, image_shape).clone(
                dtype=getattr(jnp, dtype))

        if not augment:
            def augment_in_graph(self, x, rng):
                return x
    return Jax


def _torch_cls(base, augment=True):
    class Torch(base):
        @classmethod
        def get_knob_config(cls):
            cfg = dict(base.get_knob_config())
            cfg.update(batch_size=FixedKnob(16), max_epochs=FixedKnob(1))
            return cfg

        if not augment:
            def augment_in_graph(self, x, step):
                return x
    return Torch


class JaxTinyEnas(JaxEnas):
    n_blocks = 2
    full_cells, full_channels = 3, 8
    search_cells, search_channels = 3, 8


class TorchTinyEnas(TorchEnas):
    n_blocks = 2
    full_cells, full_channels = 3, 8
    search_cells, search_channels = 3, 8


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


def _knobs_for(model):
    if model == "densenet":
        return {"arch": "densenet_tiny", "growth_rate": GROWTH,
                "learning_rate": 0.1, "weight_decay": 1e-4,
                "early_stop_epochs": 5, "quick_train": False}
    arch = _arch(5).reshape(-1).tolist()
    return {"arch": arch, "learning_rate": 0.05, "trial_epochs": 1,
            "share_params": True, "quick_train": True, "downscale": True}


def _bases(model):
    return ((JaxDenseNet, TorchDenseNet) if model == "densenet"
            else (JaxTinyEnas, TorchTinyEnas))


# --- (8) parameter files ---


@pytest.mark.parametrize("model", ["densenet", "enas"])
def test_parameter_files_interchange_both_ways(cifar_like, tmp_path,
                                               model):
    train, val = cifar_like
    knobs = _knobs_for(model)
    jbase, tbase = _bases(model)
    jcls, tcls = _jax_cls(jbase), _torch_cls(tbase)
    flat = (_densenet_pair if model == "densenet" else _enas_pair)()[1]
    meta = {"_meta/n_classes": np.asarray(N_CLASSES),
            "_meta/image_shape": np.asarray(SHAPE)}
    queries = list((255 * _images(8, 3)).astype(np.uint8))

    # JAX-written file -> the port.
    jstore = JaxParamStore(str(tmp_path / "jax"))
    jm = jcls(**jcls.validate_knobs(knobs))
    jm.load_parameters({**flat, **meta})
    pid = jstore.save(jm.dump_parameters(), session_id="s")
    jstore.flush()
    tstore = ParamStore(str(tmp_path / "jax"))
    tm = tcls(device="cpu", **tcls.validate_knobs(knobs))
    tm.load_parameters(tstore.load(pid))
    np.testing.assert_allclose(np.asarray(tm.predict(queries)),
                               np.asarray(jm.predict(queries)),
                               atol=PROB_ATOL, rtol=0)

    # The port's file -> JAX, bit for bit the same tensors.
    tstore2 = ParamStore(str(tmp_path / "torch"))
    pid2 = tstore2.save(tm.dump_parameters(), session_id="s")
    tstore2.flush()  # the dump's tensors take the write-behind
    jm2 = jcls(**jcls.validate_knobs(knobs))
    back = JaxParamStore(str(tmp_path / "torch")).load(pid2)
    jm2.load_parameters(back)
    for k in flat:
        np.testing.assert_array_equal(np.asarray(back[k]), flat[k])
    np.testing.assert_allclose(np.asarray(jm2.predict(queries)),
                               np.asarray(tm.predict(queries)),
                               atol=PROB_ATOL, rtol=0)


def test_enas_warm_starts_every_supernet_tensor_from_a_jax_file(
        cifar_like):
    """A JAX supernet's dump overlays every tensor of the port's
    supernet (and the subset the single path has)."""
    train, _ = cifar_like
    _, flat, _ = _enas_pair()
    recs = []
    prior = torch_logger.current_sink()
    torch_logger.set_sink(recs.append)
    try:
        for share in (True, False):
            knobs = dict(_knobs_for("enas"), share_params=share,
                         quick_train=share)
            cls = _torch_cls(TorchTinyEnas)
            m = cls(device="cpu", **cls.validate_knobs(knobs))
            m.train(train, shared_params=flat)
            n = len([k for k in m.dump_parameters()
                     if not k.startswith("_")])
            msgs = [r["values"]["msg"] for r in recs
                    if str(r.get("values", {}).get("msg", "")).startswith(
                        "warm-started")]
            assert msgs[-1] == f"warm-started {n} shared tensors"
    finally:
        torch_logger.set_sink(prior)
    assert n < len(flat)


# --- chip_util's FLOP count ---


@pytest.mark.parametrize("model", ["densenet", "enas"])
def test_mac_count_matches_flop_counter(model):
    from torch.utils.flop_counter import FlopCounterMode

    if model == "densenet":
        m = TorchDenseNet(device="cpu", arch="densenet_tiny",
                          growth_rate=GROWTH)
    else:
        m = TorchTinyEnas(device="cpu", **TorchTinyEnas.validate_knobs(
            _knobs_for("enas")))
    net = m._new_net(N_CLASSES, SHAPE)
    macs = m._macs(net, SHAPE)
    counter = FlopCounterMode(display=False)
    net.eval()
    with counter, torch.no_grad():
        m._logits(net, torch.zeros((1, *SHAPE)))
    assert counter.get_total_flops() == 2 * macs
