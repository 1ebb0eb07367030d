"""One process of the cross-process data-parallel tests
(``tests/test_torch_dist*.py``), run as a script:

    python tests/_torch_dist_child.py FAMILY DATA OUT INIT N RANK LOCAL

With ``N`` > 0 it joins a node of ``N`` processes at ``INIT`` (a
``file://`` or ``tcp://`` address) as process ``RANK`` with ``LOCAL``
CPU entries, binds a group over the whole global list and trains
``FAMILY`` on the set under ``DATA`` (a step every process runs). With
``N`` = 0 it is the one-process mesh of ``LOCAL`` entries that all name
the CPU. Either way it writes to ``OUT`` (an ``.npz``) the losses the
train logged, the rows each step took, the mesh's dp and the parameters
after training, then prints ``DIST CHILD OK``. It imports nothing of
JAX: a child is the port alone.
"""

import os
import sys

os.environ.setdefault("RAFIKI_TPU_PLATFORM", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from rafiki_torch.model import torch_model  # noqa: E402
from rafiki_torch.model.logger import logger  # noqa: E402
from rafiki_torch.models import layers  # noqa: E402
from rafiki_torch.parallel import ChipGroup, device_get_tree, dist  # noqa: E402

FAMILIES = {
    "lm": ("TorchTransformerLM", "token",
           {"d_model": 128, "n_layers": 1, "seq_len": 16, "vocab_size": 64,
            "batch_size": 8, "train_steps": 2, "steps_per_dispatch": 1,
            "learning_rate": 1e-3, "remat": "none", "quick_train": False}),
    "ff": ("TorchFeedForward", "image",
           {"hidden_layer_count": 1, "hidden_layer_units": 16,
            "learning_rate": 1e-2, "batch_size": 16, "max_epochs": 1}),
    "vit": ("TorchViT", "image",
            {"d_model": 32, "n_heads": 2, "patch": 4, "depth": 2,
             "learning_rate": 3e-3, "weight_decay": 1e-2, "batch_size": 16,
             "max_epochs": 1}),
    "densenet": ("TorchDenseNet", "image",
                 {"arch": "densenet_small", "growth_rate": 4,
                  "learning_rate": 0.1, "weight_decay": 1e-4,
                  "batch_size": 16, "max_epochs": 1, "early_stop_epochs": 5,
                  "quick_train": False}),
    "tables": ("TorchTabMlpClf", "table",
               {"hidden": 24, "depth": 2, "learning_rate": 1e-2,
                "batch_size": 16, "max_epochs": 1, "seed": 0}),
    "bilstm": ("TorchPosTagger", "corpus",
               {"embed_dim": 16, "hidden": 12, "vocab_size": 500,
                "max_len": 12, "learning_rate": 1e-2, "batch_size": 16,
                "max_epochs": 1, "seed": 0}),
    "tagger": ("TorchTransformerTagger", "corpus",
               {"d_model": 32, "n_heads": 2, "n_layers": 2, "max_len": 16,
                "vocab_size": 500, "learning_rate": 3e-3, "batch_size": 16,
                "max_epochs": 1, "dropout": 0.0, "seed": 0}),
}

#: The sets, by kind: 32 rows, so a batch of 16 is two steps.
SETS = {
    "image": ("make_synthetic_image_dataset",
              {"n_train": 32, "n_val": 8, "image_shape": (8, 8, 3),
               "n_classes": 3, "seed": 0}),
    "token": ("make_synthetic_token_dataset",
              {"n_train": 2000, "n_val": 200, "vocab_size": 64, "seed": 0}),
    "table": ("make_synthetic_tabular_dataset",
              {"n_train": 32, "n_val": 8, "n_features": 5, "n_classes": 3,
               "seed": 0}),
    "corpus": ("make_synthetic_corpus_dataset",
               {"n_train": 32, "n_val": 8, "vocab": 100, "n_tags": 4,
                "max_len": 10, "seed": 0}),
}


def make_set(kind: str, root: str) -> str:
    """The train set's path of ``kind`` under ``root`` (made once)."""
    from rafiki_torch import datasets

    fn, kw = SETS[kind]
    out = getattr(datasets, fn)(os.path.join(root, kind), **kw)
    return out[0]


def _rows_seen(model) -> list:
    """Wrap the family's per-step entry so each step's row count is
    noted (the dp batch rule)."""
    seen = []
    if isinstance(model, torch_model.TorchModel):
        real = torch_model._TrainSteps.new_epoch

        def new_epoch(self, order, real=real):
            seen.append(int(np.asarray(order).shape[1]))
            return real(self, order)

        torch_model._TrainSteps.new_epoch = new_epoch
        return seen
    cls = type(model)
    for name in ("_mesh_loss", "train_logits", "_apply", "logits"):
        real = getattr(cls, name, None)
        if real is None:
            continue

        def wrapped(self, *args, real=real, **kw):
            if torch.is_grad_enabled():
                seen.append(int(args[-1].shape[0] if name == "_mesh_loss"
                                else args[1].shape[0]))
            return real(self, *args, **kw)

        setattr(cls, name, wrapped)
        return seen
    return seen


def main(argv) -> None:
    family, data, out, init, n, rank, local = argv
    n, rank, local = int(n), int(rank), int(local)
    layers.COMPUTE = torch.float32
    from rafiki_torch import models

    cls_name, kind, knobs = FAMILIES[family]
    if os.environ.get("DIST_BATCH"):
        knobs = dict(knobs, batch_size=int(os.environ["DIST_BATCH"]))
    path = make_set(kind, data)
    if n:
        dist.initialize(init, n, rank, local_devices=["cpu"] * local)
        group = ChipGroup(indices=tuple(range(dist.device_count())),
                          device_type="cpu")
    else:
        group = ChipGroup(indices=(0,) * local, device_type="cpu")
    cls = getattr(models, cls_name)
    model = cls(device="cpu", **knobs)
    seen = _rows_seen(model)
    recs = []
    logger.set_sink(recs.append)
    group.bind_to_thread()
    try:
        torch.manual_seed(0)
        with dist.every_process():
            model.train(path)
        dp = model.mesh.shape["dp"]
        params = device_get_tree(dict(model.dump_parameters()))
    finally:
        ChipGroup.unbind_thread()
        logger.set_sink(None)
        dist.shutdown()
    losses = [r["values"]["loss"] for r in recs
              if r.get("type") == "values" and "loss" in r.get("values", {})]
    np.savez(out, __losses=np.asarray(losses, np.float64),
             __rows=np.asarray(seen, np.int64), __dp=np.asarray(dp),
             **{k: np.asarray(v) for k, v in params.items()})
    print("DIST CHILD OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
