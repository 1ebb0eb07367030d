"""Resolve a stored model row back into a ``BaseModel`` subclass.

The port's copy of ``rafiki_tpu/utils/model_loader.py``, over the
port's ``BaseModel``. A model is stored as either:

- ``model_class`` = ``"package.module:ClassName"``, imported (the path
  of the bundled models, e.g.
  ``rafiki_torch.models.feedforward:TorchFeedForward``), or
- ``model_source`` = the class's Python source with ``model_class`` =
  ``"ClassName"``, run in a fresh module (the path of a model uploaded
  through ``POST /models``; only an authenticated model developer can
  upload one).
"""

from __future__ import annotations

import importlib
import sys
import types
from typing import Optional, Type

from ..model.base import BaseModel


def model_class_path(cls: Type[BaseModel]) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def load_model_class(model_class: str,
                     model_source: Optional[str] = None) -> Type[BaseModel]:
    if model_source:
        name = f"_rafiki_user_model_{abs(hash(model_source))}"
        mod = types.ModuleType(name)
        # Registered before the source runs, and kept: a class resolves
        # its annotations through sys.modules[cls.__module__]. Keyed by
        # the source's hash, so a reload of the same source replaces it.
        sys.modules[name] = mod
        try:
            exec(compile(model_source, "<model_source>", "exec"),
                 mod.__dict__)
            cls = getattr(mod, model_class.split(":")[-1], None)
        except BaseException:
            del sys.modules[name]
            raise
    else:
        module_name, _, qualname = model_class.partition(":")
        mod = importlib.import_module(module_name)
        cls = mod
        for part in qualname.split("."):
            cls = getattr(cls, part, None)
            if cls is None:
                break
    if cls is None or not (isinstance(cls, type)
                           and issubclass(cls, BaseModel)):
        raise ValueError(
            f"{model_class!r} does not resolve to a BaseModel subclass")
    return cls
