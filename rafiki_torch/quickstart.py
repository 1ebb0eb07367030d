"""Quickstart: the whole app-developer flow through the ``Client``.

The port's counterpart of ``examples/scripts/quickstart.py``, on
``rafiki_torch.models.feedforward:TorchFeedForward``: a superadmin
creates a model developer, who registers the model, runs a train job
whose trials the advisor service proposes, deploys the best trials as
an inference job and queries it through ``POST /predict``. It prints
``QUICKSTART OK`` at the end.

Against a running admin:

    python -m rafiki_torch.quickstart --train data/x_train.npz \\
        --val data/x_val.npz --admin-host 127.0.0.1 --admin-port 3000

Self-contained, on the card (an in-process ``LocalPlatform`` and a
synthetic fashion-MNIST-shaped set):

    python -m rafiki_torch.quickstart --local --synthetic

``--device cpu`` runs the local platform on the CPU instead.
"""

import argparse
import tempfile

import numpy as np

FF_CLASS = "rafiki_torch.models.feedforward:TorchFeedForward"


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--admin-host", default="127.0.0.1")
    p.add_argument("--admin-port", type=int, default=3000)
    p.add_argument("--local", action="store_true",
                   help="start an in-process platform (no external admin)")
    p.add_argument("--synthetic", action="store_true",
                   help="use a synthetic fashion-MNIST-shaped dataset")
    p.add_argument("--train", help="train dataset path (.npz)")
    p.add_argument("--val", help="validation dataset path")
    p.add_argument("--model-class", default=FF_CLASS)
    p.add_argument("--trials", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="the local platform's device: cuda (the default) "
                        "or cpu")
    args = p.parse_args(argv)

    from rafiki_torch.client import Client
    from rafiki_torch.constants import BudgetOption, TaskType, UserType
    from rafiki_torch.model.dataset import load_image_dataset

    workdir = tempfile.mkdtemp(prefix="rafiki_torch_quickstart_")
    platform = None
    if args.local:
        from rafiki_torch.platform import LocalPlatform
        platform = LocalPlatform(workdir=workdir, http=True,
                                 device=args.device)
        args.admin_port = platform.admin_port

    if args.synthetic:
        from rafiki_torch.datasets import make_synthetic_image_dataset
        args.train, args.val = make_synthetic_image_dataset(
            workdir, n_train=2048, n_val=256, image_shape=(28, 28, 1),
            n_classes=10, name="fashion_mnist")
    if not args.train or not args.val:
        raise SystemExit("--train/--val or --synthetic is required")

    try:
        # 1. A superadmin creates a model developer.
        root = Client(args.admin_host, args.admin_port)
        root.login("superadmin@rafiki", "rafiki")
        try:
            root.create_user("dev@example.com", "pw",
                             UserType.MODEL_DEVELOPER)
        except Exception:
            pass  # already made by an earlier run

        dev = Client(args.admin_host, args.admin_port)
        dev.login("dev@example.com", "pw")

        # 2. Register the model.
        model = dev.create_model("quickstart-ff",
                                 TaskType.IMAGE_CLASSIFICATION,
                                 args.model_class)
        print("model:", model["id"])

        # 3. A train job: the advisor service searches the knob space.
        job = dev.create_train_job(
            "quickstart-app", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: args.trials},
            args.train, args.val)
        print("train job:", job["id"])
        done = dev.wait_until_train_job_done(job["id"], timeout=3600)
        assert done["status"] == "STOPPED", done
        best = dev.get_best_trials_of_train_job(job["id"], max_count=2)
        print("best trials:", [(t["id"][:8], round(t["score"], 4))
                               for t in best])

        # 4. Deploy the ensemble and query it.
        inf = dev.create_inference_job(job["id"], max_models=1)
        host = dev.get_inference_job(inf["id"])["predictor_host"]
        print("predictor:", host)
        val_ds = load_image_dataset(args.val)
        out = dev.predict(host, queries=[val_ds.images[i] for i in range(4)])
        preds = out["predictions"]
        acc = float(np.mean([int(np.argmax(pr)) == val_ds.labels[i]
                             for i, pr in enumerate(preds)]))
        print(f"served {len(preds)} predictions; sample accuracy {acc:.2f}")

        dev.stop_inference_job(inf["id"])
        print("QUICKSTART OK")
    finally:
        if platform is not None:
            platform.shutdown()


if __name__ == "__main__":
    main()
