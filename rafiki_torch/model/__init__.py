"""Model SDK of the port: knobs, the BaseModel contract, datasets and
the developer's self-check. ``TorchModel`` lives in
:mod:`rafiki_torch.model.torch_model`."""

from .base import BaseModel, Params, params_size_bytes
from .dataset import (CorpusDataset, ImageDataset, TabularDataset,
                      load_corpus_dataset, load_dataset_of_corpus,
                      load_dataset_of_image_files, load_image_dataset,
                      load_tabular_dataset, normalize_query,
                      write_corpus_dataset, write_image_dataset_npz,
                      write_image_files_dataset, write_tabular_dataset)
from .dev import test_model_class
from .knobs import (ArchKnob, BaseKnob, CategoricalKnob, FixedKnob,
                    FloatKnob, IntegerKnob, PolicyKnob)

__all__ = ["ArchKnob", "BaseKnob", "BaseModel", "CategoricalKnob",
           "CorpusDataset", "FixedKnob", "FloatKnob", "ImageDataset",
           "IntegerKnob", "Params", "PolicyKnob", "TabularDataset",
           "load_corpus_dataset", "load_dataset_of_corpus",
           "load_dataset_of_image_files", "load_image_dataset",
           "load_tabular_dataset", "normalize_query", "params_size_bytes",
           "test_model_class", "write_corpus_dataset",
           "write_image_dataset_npz", "write_image_files_dataset",
           "write_tabular_dataset"]
