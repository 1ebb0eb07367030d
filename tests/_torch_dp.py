"""Shared set-up of the data- and tensor-parallel tests
(``tests/test_torch_dp_*.py``).

``bound(n)`` (from ``_torch_modes``) binds ``n`` of the reference's 8
virtual CPU devices and a port group of ``n`` CPU entries, so that both
packages' meshes have the same shape. ``record_puts`` notes every numpy
array a reference module hands ``jax.device_put``: how the tests see
the rows the reference's train steps take. ``train`` runs a model's
``train`` and returns its epoch records; ``close_updates`` holds each
tensor's update against the reference's.
"""

import numpy as np

from _torch_modes import ENTRIES, bound


class _Puts:
    """A module's ``jax``, its ``device_put`` noting numpy arguments."""

    def __init__(self, real, seen):
        self._real, self._seen = real, seen

    def __getattr__(self, name):
        return getattr(self._real, name)

    def device_put(self, x, *args, **kwargs):
        if isinstance(x, np.ndarray):
            self._seen.append(np.array(x, copy=True))
        return self._real.device_put(x, *args, **kwargs)


def record_puts(monkeypatch, module):
    """The list the reference ``module``'s ``jax.device_put`` calls fill
    with their numpy arguments, in order."""
    import jax

    seen = []
    monkeypatch.setattr(module, "jax", _Puts(jax, seen))
    return seen


def train(logger, model, path, shared=None, **kw):
    """``model.train(path, ...)``; the epoch records it logged."""
    recs = []
    prior = logger.current_sink()
    logger.set_sink(recs.append)
    try:
        if shared is not None:
            kw["shared_params"] = shared
        model.train(path, **kw)
    finally:
        logger.set_sink(prior)
    return [r["values"] for r in recs
            if r["type"] == "values" and "epoch" in r.get("values", {})]


def close_updates(a, b, start, share, keys=None):
    """Each tensor of ``start`` (or of its ``keys``) moved in ``a``, the
    reference's, and ``b`` within ``share`` of that update's norm of
    ``a``."""
    for k in (start if keys is None else keys):
        step = np.linalg.norm(a[k] - start[k])
        assert step > 0, k
        assert np.linalg.norm(b[k] - a[k]) <= share * step, (
            k, float(np.linalg.norm(b[k] - a[k]) / step))


def f32_jax(cls):
    """The reference's image model ``cls`` in float32 (flax's ``dtype``)
    and without augmentation."""
    import jax.numpy as jnp

    class Jax32(cls):
        def create_module(self, n_classes, image_shape):
            return super().create_module(n_classes, image_shape).clone(
                dtype=jnp.float32)

        def augment_in_graph(self, x, rng):
            return x
    return Jax32


def zoo_step(jm, tm, path, start, val, queries):
    """Under a bound group of 4: ``jm`` (the reference) and ``tm`` (the
    port) each train from ``start``; then both answer ``queries`` and
    evaluate ``val`` on the same parameters, the reference's trained
    ones loaded into a second port model of ``tm``'s class and knobs.
    Returns ``(reference records, port records, reference parameters,
    port parameters, reference probabilities, port probabilities,
    reference accuracy, port accuracy)``."""
    from rafiki_torch.model.logger import logger as torch_logger
    from rafiki_tpu.model.logger import logger as jax_logger

    with bound():
        jrec = train(jax_logger, jm, path, start)
        trec = train(torch_logger, tm, path, start)
        assert dict(tm.mesh.shape) == dict(jm.mesh.shape)
        a = {k: np.asarray(v) for k, v in jm.dump_parameters().items()}
        b = tm.dump_parameters()
        served = type(tm)(device="cpu", **tm.knobs)
        served.load_parameters(a)
        pj = np.asarray(jm.predict(queries))
        pt = np.asarray(served.predict(queries))
        ej, et = jm.evaluate(val), served.evaluate(val)
        assert served.mesh.size == 4
    return jrec, trec, a, b, pj, pt, ej, et


__all__ = ["ENTRIES", "bound", "close_updates", "f32_jax", "record_puts",
           "train", "zoo_step"]
