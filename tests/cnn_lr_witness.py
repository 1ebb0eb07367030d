"""``JaxCnn`` and ``TorchCnn`` trained side by side on the CPU at the
learning rates given, to show whether the two move alike.

Both start from the same weights (the reference's initialisation, handed
to each as ``shared_params``) and train on the same synthetic
CIFAR-10-shaped set (32×32×3, 10 classes, the generator and seed of
``chip_smoke.py``'s zoo phases) at full width (16/16) with the CNN's
Adam, weight decay 1e-4 coupled into the moments, under the cosine. Both
compute in float32: the reference's bf16 convolutions are too slow on a
CPU. Prints each epoch's mean loss and train accuracy, and the val
accuracy at the end, for each side and learning rate.

Run (on an 8-core CPU the reference's side takes about 46 minutes a
learning rate at these settings, the port's under a minute):

    JAX_PLATFORMS=cpu python tests/cnn_lr_witness.py --lr 3e-3 1e-3 \\
        --batch 256 --steps 10 --epochs 4
"""

import argparse
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rafiki_torch.datasets import make_synthetic_image_dataset  # noqa: E402
from rafiki_torch.model.logger import logger as torch_logger  # noqa: E402
from rafiki_torch.models import TorchCnn, layers  # noqa: E402
from rafiki_tpu.model.logger import logger as jax_logger  # noqa: E402
from rafiki_tpu.models.cnn import JaxCnn, _Cnn  # noqa: E402

SHAPE = (32, 32, 3)
N_CLASSES = 10
SEED = 0  # chip_smoke.py's SEED


class _JaxCnn32(JaxCnn):
    def create_module(self, n_classes, image_shape):
        return super().create_module(n_classes, image_shape).clone(
            dtype=jnp.float32)


def _epochs(logger, model, path, start):
    recs = []
    prior = logger.current_sink()
    logger.set_sink(recs.append)
    try:
        model.train(path, shared_params=start)
    finally:
        logger.set_sink(prior)
    return [r["values"] for r in recs if r.get("type") == "values"
            and "epoch" in r.get("values", {})]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-3, 1e-3])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=10,
                    help="steps an epoch")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--n-val", type=int, default=1024)
    args = ap.parse_args()
    layers.COMPUTE = torch.float32
    start = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        _Cnn(n_classes=N_CLASSES).init(jax.random.key(SEED),
                                       jnp.zeros((1, *SHAPE))),
        sep="/").items()}
    with tempfile.TemporaryDirectory() as tmp:
        train, val = make_synthetic_image_dataset(
            tmp, n_train=args.batch * args.steps, n_val=args.n_val,
            image_shape=SHAPE, n_classes=N_CLASSES, seed=SEED,
            name="cifar10")
        for lr in args.lr:
            knobs = {"width_16ths": 16, "batch_size": args.batch,
                     "learning_rate": lr, "weight_decay": 1e-4,
                     "max_epochs": args.epochs, "early_stop_epochs": 0}
            for side, model, logger in (
                    ("reference", _JaxCnn32(**knobs), jax_logger),
                    ("port", TorchCnn(device="cpu", **knobs),
                     torch_logger)):
                t0 = time.perf_counter()
                eps = _epochs(logger, model, train, start)
                print(json.dumps({
                    "side": side, "lr": lr, "batch": args.batch,
                    "steps_an_epoch": args.steps,
                    "loss": [round(e["loss"], 4) for e in eps],
                    "train_acc": [round(e["train_acc"], 4) for e in eps],
                    "val_acc": round(float(model.evaluate(val)), 4),
                    "seconds": round(time.perf_counter() - t0, 1)}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
