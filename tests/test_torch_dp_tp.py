"""``tensor_parallel`` 2 over a group of 4 entries (dp 2 × tp 2) against
the reference on 4 of its 8 virtual CPU devices.

The port splits the leaves that the reference's ``variables_shardings``
splits (``param_spec`` on flax's layout: a kernel whose output features
are a multiple of tp and at least 256), mapped to its own layouts
(``parallel.data.port_spec``): at d_model 128 ViT's QKV (384 features)
and first FFN (512) kernels of every block, the CNN's last two
convolutions and first dense layer (256), none of FeedForward's (at most
128 features). Each such layer computes its tp ranks' output slices on
their devices (``layers.column``); each step test counts those calls.
ViT's step, predict and evaluate hold ``tests/test_torch_dp_zoo2.py``'s
tolerances; FeedForward's (bf16) holds ``tests/test_torch_dp_zoo.py``'s
(the CNN's step is in ``tests/test_torch_dp_tp_cnn.py``). FeedForward's step runs its supernet
widened to 256 units in both packages (``MAX_UNITS``), so that its three
hidden kernels split: at the knob space's 128 none does.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util

from _torch_dp import bound, close_updates, zoo_step
from rafiki_torch.model.bridge import dense_to_jax, jax_name
from rafiki_torch.models import TorchCnn, TorchFeedForward, TorchViT, layers
from rafiki_torch.models import feedforward as torch_ff
from rafiki_torch.parallel.data import port_spec
from rafiki_tpu.models import JaxCnn, JaxFeedForward, JaxViT
from rafiki_tpu.models import feedforward as jax_ff
from rafiki_tpu.parallel.mesh import TP_AXIS, variables_shardings
from test_torch_dp_zoo import _data, _queries
from test_torch_dp_zoo2 import SHAPE, vit_step

WIDE = 256


def _widen(monkeypatch):
    """Both packages' FeedForward supernet at ``WIDE`` units a layer."""
    monkeypatch.setattr(jax_ff, "MAX_UNITS", WIDE)
    monkeypatch.setattr(torch_ff, "MAX_UNITS", WIDE)


def _wide_params(seed, shape, n_classes):
    """The widened supernet's parameters in the reference's flat
    names."""
    rng = np.random.default_rng(seed)
    widths = [int(np.prod(shape)), WIDE, WIDE, WIDE, n_classes]
    p = {}
    for i in range(4):
        p[f"params/Dense_{i}/kernel"] = (
            rng.standard_normal((widths[i], widths[i + 1]))
            / np.sqrt(widths[i])).astype(np.float32)
        p[f"params/Dense_{i}/bias"] = (
            0.1 * rng.standard_normal(widths[i + 1])).astype(np.float32)
    return p


def _count_columns(monkeypatch):
    """The tp ranks of each column-parallel layer call, in order."""
    calls = []
    real = layers.column

    def column(layer, x, fn, dim=-1):
        if getattr(layer, "tp_shards", None) is not None:
            calls.append(len(layer.tp_shards))
        return real(layer, x, fn, dim)

    monkeypatch.setattr(layers, "column", column)
    return calls


def test_vit_over_dp_2_and_tp_2(tmp_path_factory, monkeypatch):
    vit_step(tmp_path_factory, monkeypatch, 2)


def test_feedforward_over_dp_2_and_tp_2(tmp_path_factory, monkeypatch):
    _widen(monkeypatch)
    shape = (12, 12, 1)
    train_path, val = _data(tmp_path_factory, shape, 4, 32)
    start = _wide_params(5, shape, 4)
    knobs = {"hidden_layer_count": 3, "hidden_layer_units": WIDE,
             "learning_rate": 3e-3, "batch_size": 16, "max_epochs": 1,
             "tensor_parallel": 2}
    net = TorchFeedForward(device="cpu").create_module(4, shape)
    assert _port_split(net.state_dict()) == [
        f"params/Dense_{i}/kernel" for i in range(3)]
    calls = _count_columns(monkeypatch)
    jrec, trec, a, b, pj, pt, ej, et = zoo_step(
        JaxFeedForward(**knobs), TorchFeedForward(device="cpu", **knobs),
        train_path, start, val, _queries(shape))
    # 2 steps, 2 dp ranks and 3 split layers; then the predict's and the
    # evaluation's forwards.
    assert len(calls) > 2 * 2 * 3 and set(calls) == {2}
    assert abs(jrec[0]["loss"] - trec[0]["loss"]) <= 5e-3
    close_updates(a, b, start, 0.10)
    np.testing.assert_allclose(pt, pj, atol=3.9e-3, rtol=0)
    assert et == ej


def _port_split(named):
    """The flax names of the port's leaves that ``port_spec`` splits
    over tp 2."""
    return sorted(jax_name(k, v.dim())[0] for k, v in named.items()
                  if "tp" in port_spec(k, v, 2))


def _reference_split(jcls, flat):
    with bound():
        jm = jcls(tensor_parallel=2)
        shard = variables_shardings(traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in flat.items()}, sep="/"),
            jm.mesh)
    return sorted(k for k, s in traverse_util.flatten_dict(
        shard, sep="/").items() if TP_AXIS in tuple(s.spec))


@pytest.mark.parametrize("family", ["vit", "cnn", "feedforward",
                                    "feedforward_wide"])
def test_tensor_parallel_splits_the_reference_s_leaves(family, monkeypatch):
    """The reference's rule runs on the port's leaves in flax's names and
    layouts (the bridge's exact round trip)."""
    if family == "feedforward_wide":
        _widen(monkeypatch)
    tcls, jcls, n_classes, shape = {
        "vit": (TorchViT, JaxViT, 10, SHAPE),
        "cnn": (TorchCnn, JaxCnn, 10, (16, 16, 3)),
        "feedforward": (TorchFeedForward, JaxFeedForward, 4, (12, 12, 1)),
        "feedforward_wide": (TorchFeedForward, JaxFeedForward, 4,
                             (12, 12, 1)),
    }[family]
    net = tcls(device="cpu").create_module(n_classes, shape)
    want = _reference_split(jcls, dense_to_jax(net.state_dict()))
    assert _port_split(net.state_dict()) == want
    # ViT: 6 blocks' Dense_0 and Dense_2; the CNN: Conv_4, Conv_5, Dense_0;
    # the widened FeedForward: its 3 hidden layers.
    assert len(want) == {"vit": 12, "cnn": 3, "feedforward": 0,
                         "feedforward_wide": 3}[family]
