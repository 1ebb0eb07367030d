"""RTA401/RTA402 true positives, in the port's torch form.

RTA401: tensors a staging/residency cache holds, written in place or
made as views of a cached host array. RTA402: a CUDA graph's static
output handed out by the method that replays the graph."""

import numpy as np
import torch

_STAGE_CACHE = {}


def staged_arrays(key, ds, device):
    """The F7 shape: the entry the cache keeps is made by
    ``torch.from_numpy``, a view of the host cache's read-only array."""
    return _staged(key, lambda: (torch.from_numpy(ds.images).to(device),
                                 torch.as_tensor(ds.labels)))


def _staged(key, make):
    entry = _STAGE_CACHE.get(key)
    if entry is None:
        entry = _STAGE_CACHE[key] = make()
    return entry


def fetch_resident(key):
    """A neutral-named helper whose return is cache-tainted."""
    return _STAGE_CACHE[key]


def fetch_again(key):
    """A helper-calls-helper chain."""
    return fetch_resident(key)


def normalise_in_place(key, device):
    images, labels = staged_arrays(key, None, device)
    images.div_(255.0)                  # a method ending in _
    labels[0] = 7                       # a subscript store
    return images


def write_through_helpers(key, src):
    resident = fetch_again(key)
    resident[0].copy_(src)              # through a view
    torch.add(src, 1.0, out=resident)   # an out= argument
    view = resident.view(-1)
    view += 1                           # an augmented assignment


def alias_a_cached_host_array(key):
    host = fetch_resident(key)
    return torch.from_numpy(host)       # a tensor over the cache's array


class Runner:
    """The graph's static output leaves the replaying method."""

    def __init__(self, fn, x):
        self.fn = fn
        self.static_in = x
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.static_out = fn(self.static_in)
        self.results = []

    def __call__(self, x):
        self.static_in.copy_(x)
        self.graph.replay()
        return self.static_out


class Engine:
    """The captured output is bound through a local, as a tuple."""

    def capture(self, args):
        graph = torch.cuda.CUDAGraph()
        with graph_capture(graph):
            out = self._step(*args)
        self._graph, self._out = graph, out

    def step(self):
        self._graph.replay()
        ids, logits = self._out
        return self._out

    def keep(self):
        self._graph.replay()
        latest = self._out
        self.history.append(latest)

    def _step(self, *args):
        return args


def graph_capture(graph):
    return torch.cuda.graph(graph)


_ = np
