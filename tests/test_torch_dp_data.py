"""``rafiki_torch.parallel.data`` on its own, on the CPU: the reference's
placement rule on the port's layouts, the ranks' replicas, the lockstep
sum, column-parallel layers and the whole batch's BatchNorm.

Meshes are of 4 CPU entries (one device named 4 times), so a rank's
copy of a leaf is the leaf itself: what a card standing for 4 entries
does. Tolerances: a column-parallel layer's bf16 output within one bf16
ulp (2^-7 of its largest value) of the unsplit one (each output
feature is the same sum, its f32 accumulation blocked another way by
the narrower product); the ranks' gradients
within 1e-5 of the whole batch's (f32 sums in another order); the
BatchNorm over 4 ranks within 1e-5 of one over the whole batch (its
variance is flax's ``E[x²] − E[x]²`` of the ranks' sums, the library's
a two-pass one: measured 1.4e-6 on outputs near 2).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import threading
import types

import numpy as np
import pytest
import torch
from torch import nn

from rafiki_torch.models.layers import BatchNorm, Conv, Dense
from rafiki_torch.parallel.chips import ChipGroup
from rafiki_torch.parallel.data import (DpSum, group_mesh, mesh_apply,
                                        place_leaves, port_spec, rank_coord,
                                        replica, row_blocks, run_ranks)
from rafiki_torch.parallel.mesh import build_mesh, param_spec

CPU4 = ["cpu"] * 4


@pytest.mark.parametrize("n,parts,want", [
    (8, 4, [(0, 2), (2, 4), (4, 6), (6, 8)]),
    (6, 4, [(0, 2), (2, 4), (4, 5), (5, 6)]),
    (2, 4, [(0, 1), (1, 2), (2, 2), (2, 2)]),
])
def test_row_blocks(n, parts, want):
    assert row_blocks(n, parts) == want


@pytest.mark.parametrize("key,shape,want", [
    ("Dense_0.weight", (512, 64), ("tp", None)),       # flax (64, 512)
    ("Dense_0.weight", (128, 512), ()),                # 128 features
    ("Dense_0.weight", (300, 64), ("tp", None)),       # 300 = 2 × 150
    ("Conv_4.weight", (256, 128, 3, 3), ("tp", None, None, None)),
    ("Conv_4.bias", (256,), ()),
    ("Embed_0.weight", (1000, 256), (None, "tp")),     # flax's layout
    ("pos_embed", (1, 17, 256), (None, None, "tp")),
    ("OptimizedLSTMCell_0.weight_ih", (1024, 64), ()),  # kept otherwise
])
def test_port_spec_splits_what_the_reference_splits(key, shape, want):
    assert port_spec(key, torch.zeros(shape), 2) == want


def test_port_spec_is_param_spec_through_the_bridge_s_layout():
    conv = torch.zeros(256, 8, 3, 3)
    flax = param_spec(types.SimpleNamespace(shape=(3, 3, 8, 256)), 2)
    assert flax == (None, None, None, "tp")
    assert port_spec("Conv_0.weight", conv, 2) == ("tp", None, None, None)


def test_a_column_parallel_dense_and_conv_give_the_unsplit_output():
    gen = torch.Generator().manual_seed(0)
    conv = nn.Sequential()
    conv.add_module("Conv_0", Conv(3, 256, 3, gen, padding=1,
                                   use_bias=True))
    dense = nn.Sequential()
    dense.add_module("Dense_0", Dense(16, 512, gen))
    x = torch.rand(2, 3, 5, 5, generator=gen)
    h = torch.rand(4, 16, generator=gen)
    mesh = build_mesh(CPU4, tp=2)
    for mod, inp, half in ((conv, x, 128), (dense, h, 256)):
        rep = replica(mod, place_leaves(dict(mod.named_parameters()), mesh),
                      rank_coord(1))
        layer = rep[0]
        assert [d for d, _, _ in layer.tp_shards] == [torch.device("cpu")] * 2
        assert [w.shape[0] for _, w, _ in layer.tp_shards] == [half] * 2
        with torch.no_grad():
            got, want = rep(inp).float(), mod(inp).float()
        assert float((got - want).abs().max()) <= 2 ** -7 * float(
            want.abs().max())


def test_ranks_gradients_add_up_to_the_whole_batch_s():
    gen = torch.Generator().manual_seed(1)
    net = Dense(8, 4, gen, f32=True)
    x = torch.rand(8, 8, generator=gen)
    mesh = build_mesh(CPU4)
    out = mesh_apply(mesh, net, 8, lambda dev, lo, hi: (x[lo:hi],),
                     torch.device("cpu"))
    out.square().mean().backward()
    got = net.weight.grad.clone()
    net.weight.grad = None
    net(x).square().mean().backward()
    np.testing.assert_allclose(got.numpy(), net.weight.grad.numpy(),
                               atol=1e-5, rtol=0)


def test_batchnorm_over_ranks_is_the_whole_batch_s():
    """dp 4 in lockstep: the output and the running statistics of one
    BatchNorm over the whole batch; only rank 0 writes them."""
    x = torch.rand(8, 6, 3, 3) * 2 + 0.5
    whole, ranked = BatchNorm(6), BatchNorm(6)
    with torch.no_grad():
        for bn in (whole, ranked):
            bn.weight.uniform_(0.5, 1.5)
        ranked.weight.copy_(whole.weight)
    want = whole(x)
    got = mesh_apply(build_mesh(CPU4), ranked, 8,
                     lambda dev, lo, hi: (x[lo:hi],), torch.device("cpu"))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=1e-5, rtol=0)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(ranked, name).numpy(),
                                   getattr(whole, name).numpy(), atol=1e-5,
                                   rtol=0)


def test_lockstep_ranks_each_need_rows():
    with pytest.raises(ValueError, match="without rows"):
        mesh_apply(build_mesh(CPU4), BatchNorm(2), 3,
                   lambda dev, lo, hi: (torch.rand(hi - lo, 2, 1, 1),),
                   torch.device("cpu"))


def test_a_rank_that_raises_breaks_the_others_wait():
    sync = DpSum(3)

    def rank(i):
        def fn():
            if i == 1:
                raise RuntimeError("rank 1 failed")
            return sync.rank(i)(torch.ones(1))
        return fn

    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks([rank(i) for i in range(3)], sync)
    assert threading.active_count() < 50


def test_lockstep_sums_in_rank_order_on_every_rank():
    sync = DpSum(4)
    out = run_ranks([lambda i=i: sync.rank(i)(torch.tensor([float(i)]))
                     for i in range(4)], sync)
    assert [float(o) for o in out] == [6.0] * 4


def test_group_mesh_is_the_bound_group_s_or_the_device_alone():
    cpu = torch.device("cpu")
    assert group_mesh(cpu).size == 1
    ChipGroup(indices=(0,) * 4, device_type="cpu").bind_to_thread()
    try:
        mesh = group_mesh(cpu, tp=2)
        assert (mesh.size, mesh.shape["dp"], mesh.shape["tp"]) == (4, 2, 2)
        with pytest.raises(ValueError, match="not divisible by"):
            group_mesh(cpu, tp=3)
    finally:
        ChipGroup.unbind_thread()
    # The model's parameters live on its device: the group must start
    # there.
    ChipGroup(indices=(0,) * 4, device_type="cuda").bind_to_thread()
    try:
        with pytest.raises(ValueError, match="is not its group's first"):
            group_mesh(cpu)
    finally:
        ChipGroup.unbind_thread()


def test_a_mesh_on_one_device_shares_the_device_s_staged_set(tmp_path):
    """4 entries naming one device hold the same tensors as the device
    alone: one cache entry, staged once."""
    from rafiki_torch.datasets import make_synthetic_image_dataset
    from rafiki_torch.model import torch_model
    from rafiki_torch.model.dataset import load_image_dataset

    path, _ = make_synthetic_image_dataset(
        str(tmp_path), n_train=16, n_val=4, image_shape=(4, 4, 1),
        n_classes=2, seed=0)
    ds = load_image_dataset(path)
    torch_model.clear_stage_cache()
    try:
        images, labels = torch_model.staged_dataset_arrays(path, ds, "cpu")
        by_dev, mesh_labels = torch_model.staged_mesh_arrays(
            path, ds, build_mesh(CPU4))
        assert list(by_dev) == [torch.device("cpu")]
        assert by_dev[torch.device("cpu")] is images
        assert mesh_labels is labels
        assert torch_model.stage_cache_info()["entries"] == 1
    finally:
        torch_model.clear_stage_cache()
