"""The port's bus and cache held against the reference's
(``rafiki_tpu.bus``, ``rafiki_tpu.cache``, ``ensemble_predictions``).

Inputs are made from a numpy seed. The wire frames must be equal as
JSON (the port writes the reference's bytes), frames decode across the
two packages both ways bit for bit, the two ``MemoryBus`` backends
answer one sequence of operations alike, and ``ensemble_predictions``
gives exactly the reference's answer (no tolerance: the same float64
arithmetic).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json

import numpy as np
import pytest

from rafiki_torch import cache as pc
from rafiki_torch.bus import MemoryBus as PortBus
from rafiki_torch.bus import connect as port_connect
from rafiki_torch.predictor.predictor import \
    ensemble_predictions as port_ensemble
from rafiki_tpu import cache as rc
from rafiki_tpu.bus import MemoryBus as RefBus
from rafiki_tpu.predictor.predictor import \
    ensemble_predictions as ref_ensemble


def _arrays():
    rng = np.random.default_rng(0)
    big = rng.standard_normal((6, 8)).astype(np.float32)
    return {
        "f32": rng.standard_normal((28, 28, 1)).astype(np.float32),
        "uint8": rng.integers(0, 256, (12, 12, 1), dtype=np.uint8),
        "int32": rng.integers(-2**31, 2**31 - 1, (3, 5), dtype=np.int32),
        "zero_d": np.asarray(rng.standard_normal(), np.float32),
        "non_contiguous": big[:, ::2],
        "transposed": big.T,
        "float64": rng.standard_normal((4,)),
        "bool": rng.random((7,)) > 0.5,
        "empty": np.zeros((0, 3), np.float32),
    }


ARRAYS = _arrays()


def _same(a, b):
    """Same dtype, shape and bytes (``np.ascontiguousarray`` would turn a
    0-d array into shape (1,))."""
    a = np.array(a, order="C")
    return (isinstance(b, np.ndarray) and a.dtype == b.dtype
            and a.shape == b.shape and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_encode_payload_frames_equal_the_reference(name):
    a = ARRAYS[name]
    value = {"q": a, "nested": [a, 3, "s", np.int64(7), np.float32(0.5)]}
    assert json.dumps(pc.encode_payload(value)) == \
        json.dumps(rc.encode_payload(value))


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_payloads_decode_across_packages_bit_for_bit(name):
    a = ARRAYS[name]
    for enc, dec in ((pc.encode_payload, rc.decode_payload),
                     (rc.encode_payload, pc.decode_payload)):
        back = dec(json.loads(json.dumps(enc([a, {"k": a}]))))
        assert _same(a, back[0])
        assert _same(a, back[1]["k"])


@pytest.mark.parametrize("name", ["f32", "uint8", "int32",
                                  "non_contiguous", "bool"])
def test_packed_batch_frames_equal_the_reference(name):
    rng = np.random.default_rng(1)
    a = ARRAYS[name]
    rows = [a] + [np.ascontiguousarray(rng.permutation(a.ravel())
                                       .reshape(a.shape)) for _ in range(4)]
    p, r = pc.PackedBatch.from_arrays(rows), rc.PackedBatch.from_arrays(rows)
    for start, count in ((0, 5), (1, 3), (4, 1)):
        assert json.dumps(p.slice(start, count)) == \
            json.dumps(r.slice(start, count))
    encoded = [rc.encode_payload(x) for x in rows]
    pe, re_ = (pc.PackedBatch.from_encoded(encoded),
               rc.PackedBatch.from_encoded(encoded))
    assert json.dumps(pe.slice(0, 5)) == json.dumps(re_.slice(0, 5))
    # Frames cross: each package's decode_batch reads the other's.
    for frame, dec in ((p.slice(0, 5), rc.decode_batch),
                       (r.slice(0, 5), pc.decode_batch)):
        back = dec(json.loads(json.dumps(frame)))
        for i, x in enumerate(rows):
            assert _same(x, np.array(back[i]))


def test_unpackable_batches_and_corrupt_frames_agree():
    mixed = [ARRAYS["f32"], ARRAYS["uint8"]]
    assert pc.PackedBatch.from_arrays(mixed) is None
    assert rc.PackedBatch.from_arrays(mixed) is None
    assert pc.PackedBatch.from_encoded([[1.0, 2.0]]) is None
    frame = pc.PackedBatch.from_arrays([ARRAYS["f32"]] * 2).slice(0, 2)
    for bad in (dict(frame, n=3), dict(frame, v=2),
                dict(frame, offsets=[0, 1]),
                dict(frame, __ndbatch__=frame["__ndbatch__"][:-8])):
        for dec in (pc.decode_batch, rc.decode_batch):
            with pytest.raises(ValueError):
                dec(bad)


def test_prediction_rows_pack_as_the_reference():
    rng = np.random.default_rng(2)
    probs = [rng.random(10).tolist() for _ in range(4)]
    cases = [probs, probs[:1], [{"error": "x"}] + probs,
             [{"__members__": ["a", "b"]}] * 2, [0.5, 0.25], ["a", "b"]]
    for preds in cases:
        assert json.dumps(pc.pack_prediction_rows(preds)) == \
            json.dumps(rc.pack_prediction_rows(preds))


def _bus_script(bus):
    """One sequence of queue and registry operations; what it saw."""
    seen = []
    bus.push("q", 1)
    bus.push_many([("q", {"a": [1, 2]}), ("r", "x"), ("q", None)])
    seen.append(bus.queue_len("q"))
    seen.append(bus.pop("q"))
    seen.append(bus.pop_all("q", max_items=1))
    seen.append(bus.pop_all("q"))
    seen.append(bus.pop("q", timeout=0.01))
    seen.append(bus.pop_all("q", timeout=0.01))
    bus.delete_queue("r")
    seen.append(bus.queue_len("r"))
    for k in ("w:j:b", "w:j:a", "x"):
        bus.set(k, {"trial_id": k})
    seen.append(bus.keys("w:j:"))
    seen.append(bus.get("w:j:a"))
    bus.delete("w:j:a")
    seen.append([bus.get("w:j:a"), bus.keys()])
    return seen


def test_memory_bus_answers_as_the_reference():
    assert _bus_script(PortBus()) == _bus_script(RefBus())
    assert port_connect("") is PortBus.shared()
    assert port_connect("memory://") is PortBus.shared()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_connect("tcp://127.0.0.1:6380")
    with pytest.raises(ValueError):
        port_connect("redis://x")


def _frames(bus, queue):
    return json.dumps(bus.pop_all(queue), sort_keys=True)


def test_cache_frames_equal_the_reference():
    """The same scatter, reply, drain and generate calls put the same
    frames on each package's bus."""
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (4, 4, 1), dtype=np.uint8)
            for _ in range(3)]
    enc = [rc.encode_payload(x) for x in imgs]
    shards = [("w1", 0, 3, "s1"), ("w2", 1, 2, "s2")]
    probs = [rng.random(4).tolist() for _ in range(3)]
    out = []
    for mod, bus in ((pc, PortBus()), (rc, RefBus())):
        c = mod.Cache(bus)
        c.send_query_shards(shards, enc, batch_id="b",
                            packed=mod.PackedBatch.from_encoded(enc),
                            packed_ok={"w1"})
        c.send_prediction_batch("b", "w1", probs, weight=2, shard="s1",
                                packed_ok=True)
        c.send_prediction_batch("b", "w2", [{"error": "E: x"}, probs[0]],
                                shard="s2")
        c.send_drain("w1")
        c.send_generate("w2", [1, 2, 3], max_new=4, temperature=0.5,
                        seed=7, eos=2, query_id="g")
        c.send_token_frame("g", "w2", {"seq": 0, "tok": [5], "done": True})
        c.register_worker("job", "w1", {"trial_id": "a,b",
                                        "wire": ["ndbatch1"]})
        out.append([_frames(bus, "q:w1"), _frames(bus, "q:w2"),
                    _frames(bus, "r:b"), _frames(bus, "r:g"),
                    c.running_workers("job"), c.running_worker_info("job")])
    assert out[0] == out[1]


def test_cache_pops_what_the_other_package_sent():
    """Shards pushed by one package's cache are popped and decoded by
    the other's; replies gathered likewise, arrays bit for bit."""
    rng = np.random.default_rng(4)
    imgs = [rng.standard_normal((3, 3)).astype(np.float32) for _ in range(4)]
    probs = [rng.random(5).astype(np.float32) for _ in range(4)]
    for send, recv in ((pc, rc), (rc, pc)):
        bus = PortBus()  # either backend carries plain dicts
        s, r = send.Cache(bus), recv.Cache(bus)
        enc = [send.encode_payload(x) for x in imgs]
        s.send_query_shards([("w", 0, 4, "s0"), ("v", 0, 4, "s1")], enc,
                            batch_id="b",
                            packed=send.PackedBatch.from_arrays(imgs),
                            packed_ok={"w"})
        (packed,) = r.pop_queries("w", timeout=0.1)
        (plain,) = r.pop_queries("v", timeout=0.1)
        assert packed["shard"] == "s0" and plain["shard"] == "s1"
        for i, x in enumerate(imgs):
            assert _same(x, np.array(packed["batch"][i]))
            assert _same(x, plain["queries"][i])
        r.send_prediction_batch("b", "w", probs, weight=2, shard="s0",
                                packed_ok=True)
        r.send_prediction_batch("b", "v", [p.tolist() for p in probs],
                                shard="s1")
        got = sorted(s.gather_prediction_batches("b", 2, timeout=1.0),
                     key=lambda x: x["shard"])
        assert [g["weight"] for g in got] == [2, 1]
        for i, p in enumerate(probs):
            assert _same(p, got[0]["predictions"][i])
            assert got[1]["predictions"][i] == p.tolist()


def test_token_frames_ride_a_cache_of_their_own():
    tf = pc.TokenFrames()
    assert isinstance(tf, pc.Cache) and isinstance(tf.bus, PortBus)
    assert tf.bus is not PortBus.shared()


def _ensemble_cases():
    rng = np.random.default_rng(5)
    cases = []
    for _ in range(200):
        n = int(rng.integers(1, 5))
        preds, weights = [], []
        for _ in range(n):
            kind = rng.integers(0, 6)
            if kind == 0:
                preds.append({"error": "RuntimeError: boom"})
            elif kind == 1:
                preds.append({"__members__": [
                    str(rng.choice(["cat", "dog"]))
                    for _ in range(int(rng.integers(1, 4)))]})
            elif kind == 2:
                preds.append(None)
            elif kind == 3:
                preds.append(str(rng.choice(["cat", "dog", "eel"])))
            else:
                preds.append(rng.random(3).tolist())
            weights.append(int(rng.integers(1, 4)))
        cases.append((preds, weights if rng.random() < 0.7 else None))
    # Pure numeric lists with weights, the packed-worker case.
    for _ in range(50):
        n = int(rng.integers(1, 4))
        cases.append(([rng.random(4).tolist() for _ in range(n)],
                      [int(w) for w in rng.integers(1, 4, n)]))
    cases.append(([[0.6, 0.4], [0.0, 1.0]], [2, 1]))
    cases.append(([{"error": "x"}, [0.0, 1.0]], [2, 1]))
    cases.append((["a", "b", "a"], [1, 5, 1]))
    cases.append(([{"__members__": ["a", "b"]}, "b"], [2, 1]))
    cases.append(([[0.5, float("nan")], [0.5, 0.5]], None))
    cases.append(([], None))
    return cases


def test_ensemble_predictions_equal_the_reference_exactly():
    for preds, weights in _ensemble_cases():
        assert json.dumps(port_ensemble(preds, weights)) == \
            json.dumps(ref_ensemble(preds, weights)), (preds, weights)
