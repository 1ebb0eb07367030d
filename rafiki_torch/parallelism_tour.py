"""Parallelism tour: every intra-trial mode of the port on one mesh.

The counterpart of ``examples/scripts/parallelism_tour.py``: trains the
same transformer tagger under each mode and prints its score, a model
knob, not a rewrite, selecting the strategy:

- dp (always on): batch data parallelism; the ranks' gradients add up
  in each parameter's one leaf.
- sp=ring:     sequence shards; each rank folds every K/V shard in turn.
- sp=alltoall: Ulysses; one re-chunk to head shards and back, K1 per
               rank on the card.
- ep:          Switch-MoE FFN, each rank computing a slice of the
               expert stack.
- pp:          GPipe microbatch pipeline over the encoder blocks.
- pp x sp:     ring attention inside the pipelined stages.
- pp x ep:     MoE stages with each stage's expert slice over ep.

Run it on the card, or on the CPU with ``--device cpu``:

    python -m rafiki_torch.parallelism_tour [--device cpu] [--mesh-entries N]

The mesh has ``--mesh-entries`` entries (default: the node's cards, or 8
on the CPU); with more entries than cards they cycle over the cards, so
one card stands for several devices. A mesh on one card shows no
speed-up: every rank's work runs on it in turn.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m rafiki_torch.parallelism_tour",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the default) or cpu")
    parser.add_argument("--mesh-entries", type=int, default=None,
                        help="mesh entries (default: the cards, 8 on the "
                             "CPU); they cycle over the cards")
    args = parser.parse_args(argv)

    import torch

    from .datasets import make_synthetic_corpus_dataset
    from .models import TorchTransformerTagger
    from .parallel.chips import ChipGroup
    from .torchenv import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        n = args.mesh_entries or cards
        group = ChipGroup(indices=tuple(i % cards for i in range(n)))
    else:
        n = args.mesh_entries or 8
        group = ChipGroup(indices=(0,) * n, device_type="cpu")
    if n < 2 or n % 2:
        print(f"need an even number of mesh entries >= 2, have {n} "
              f"(pass --mesh-entries)", file=sys.stderr)
        return 2

    group.bind_to_thread()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            train, val = make_synthetic_corpus_dataset(
                tmp, n_train=96, n_val=24, vocab=64, n_tags=4, max_len=24)
            base = dict(d_model=64, n_heads=4, n_layers=2,
                        learning_rate=1e-2, batch_size=16, max_epochs=8,
                        max_len=32, dropout=0.0, vocab_size=1024)
            modes = [
                ("dp only", {}),
                ("sp ring", dict(sequence_parallel=2)),
                ("sp alltoall", dict(sequence_parallel=2,
                                     sp_schedule="alltoall")),
                ("ep moe", dict(moe_experts=4, expert_parallel=2)),
                ("pp gpipe", dict(pipeline_parallel=2)),
            ]
            if n % 4 == 0:
                # Composed modes need 4 mesh cells beyond dp.
                modes += [
                    ("pp x sp", dict(pipeline_parallel=2,
                                     sequence_parallel=2)),
                    ("pp x ep", dict(pipeline_parallel=2, moe_experts=4,
                                     expert_parallel=2)),
                ]
            for name, extra in modes:
                model = TorchTransformerTagger(device=device, **base,
                                               **extra)
                shape = dict(model.mesh.shape)
                model.train(train)
                score = float(model.evaluate(val))
                model.destroy()
                axes = "x".join(f"{a}{v}" for a, v in shape.items() if v > 1)
                print(f"{name:12s} mesh[{axes:12s}] token-acc={score:.4f}",
                      flush=True)
    finally:
        ChipGroup.unbind_thread()
    print("PARALLELISM TOUR OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
