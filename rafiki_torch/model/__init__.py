"""Model SDK of the port: knobs, the BaseModel contract, datasets and
the developer's self-check. ``TorchModel`` lives in
:mod:`rafiki_torch.model.torch_model`."""

from .base import BaseModel, Params, params_size_bytes
from .dataset import (ImageDataset, load_image_dataset, normalize_query,
                      write_image_dataset_npz)
from .dev import test_model_class
from .knobs import (ArchKnob, BaseKnob, CategoricalKnob, FixedKnob,
                    FloatKnob, IntegerKnob, PolicyKnob)

__all__ = ["ArchKnob", "BaseKnob", "BaseModel", "CategoricalKnob",
           "FixedKnob", "FloatKnob", "ImageDataset", "IntegerKnob",
           "Params", "PolicyKnob", "load_image_dataset", "normalize_query",
           "params_size_bytes", "test_model_class",
           "write_image_dataset_npz"]
