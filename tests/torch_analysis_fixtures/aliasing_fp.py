"""RTA401/RTA402 false-positive guard: the same shapes written safely.
NO findings expected."""

import numpy as np
import torch

_STAGE_CACHE = {}


def staged_arrays(key, ds, device):
    """Copies into the cache (``torch.tensor``), as the port does."""
    return _staged(key, lambda: (torch.tensor(ds.images, device=device),
                                 torch.tensor(ds.labels)))


def _staged(key, make):
    entry = _STAGE_CACHE.get(key)
    if entry is None:
        entry = _STAGE_CACHE[key] = make()    # a slot of the cache itself
    return entry


def fetch_resident(key):
    return _STAGE_CACHE[key]


def normalise_a_copy(key, device):
    images, labels = staged_arrays(key, None, device)
    images = images.clone()
    images.div_(255.0)                  # the copy, not the entry
    picked = labels[torch.arange(2)]    # a gather makes a new tensor
    picked[0] = 7
    return images, picked


def write_elsewhere(key, src):
    resident = fetch_resident(key)
    out = torch.empty_like(resident)
    torch.add(resident, 1.0, out=out)   # the entry is only read
    buf = np.zeros(4, np.float32)
    t = torch.from_numpy(buf)           # a view of a private array
    t.add_(1.0)
    src.requires_grad_(True)
    return out, t


class Runner:
    """Returns a copy of the static output, as PredictRunner does."""

    def __init__(self, fn, x):
        self.fn = fn
        self.static_in = x
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.static_out = fn(self.static_in)

    def __call__(self, x):
        self.static_in.copy_(x)
        self.graph.replay()
        return self.static_out.clone()

    def eager(self, x):
        """No replay here: handing out the attribute is harmless."""
        return self.static_out, self.fn(x)


class Engine:
    def capture(self, args):
        graph = torch.cuda.CUDAGraph()
        with graph_capture(graph):
            out = self._step(*args)
        self._graph, self._out = graph, out

    def step(self):
        self._graph.replay()
        ids, logits = self._out
        return ids.cpu(), logits.clone()

    def _step(self, *args):
        return args


def graph_capture(graph):
    return torch.cuda.graph(graph)
