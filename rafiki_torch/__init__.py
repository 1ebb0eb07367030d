"""rafiki-torch: the PyTorch / CUDA port of rafiki-tpu for NVIDIA Hopper.

The port keeps the reference package's module names (``model``,
``models``, ``ops``, ``predictor``, ``worker``, ``utils``) so each module
has an obvious counterpart in ``rafiki_tpu``. It imports ``torch`` and
never ``jax`` or anything of the reference package.

Importing this package is cheap: submodules load torch only when they
are imported themselves.
"""

__version__ = "0.1.0"
