"""The port's generative serving on the CPU: the continuous-batching
``DecodeScheduler``, ``InferenceWorker(generate=...)``, the chunked
``StreamResponse`` and ``POST /generate``, at the TINY shape of
``tests/test_torch_lm_generate.py``.

The whole slice is held against the reference: greedy tokens streamed
by the port's ``POST /generate`` equal those of the JAX ``LMGenerator``
on the same parameters, up to the first step at which the JAX logits'
top-2 gap is below 0.16 (past a near-tie the two may pick different
tokens).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from rafiki_torch.cache import TokenFrames
from rafiki_torch.models import TorchTransformerLM
from rafiki_torch.predictor import PredictorService
from rafiki_torch.utils.service import JsonHttpServer, StreamResponse
from rafiki_torch.worker import InferenceWorker
from rafiki_torch.worker.decode_scheduler import DecodeScheduler

from test_torch_lm_generate import ENGINE, NEAR_TIE, TINY, _params

KNOBS = dict(TINY)


@pytest.fixture(scope="module")
def served():
    worker = InferenceWorker(TorchTransformerLM, KNOBS, _params(),
                             device="cpu", generate=ENGINE).start()
    plain = InferenceWorker(TorchTransformerLM, KNOBS, _params(),
                            device="cpu").start()
    app = PredictorService([worker, plain], device="cpu").start()
    yield worker, app
    app.stop()
    engine = worker.scheduler.engine
    worker.stop()
    plain.stop()
    assert engine.pool.used_pages == 0   # stop() returned every page
    assert worker.scheduler is None and not worker.running


def _post(url, body, timeout=60.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _stream(url, body):
    with _post(url + "/generate", body) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        assert resp.headers["Transfer-Encoding"] == "chunked"
        return [json.loads(line) for line in resp.read().splitlines()]


def _tokens(frames):
    return [t for f in frames for t in f["tok"]]


def _check_stream(frames, n):
    assert [f["seq"] for f in frames] == list(range(len(frames)))
    assert all(not f["done"] for f in frames[:-1])
    last = frames[-1]
    assert last["done"] and last["n_tokens"] == len(_tokens(frames))
    assert last["finish"] == "eos" or (last["finish"] == "length"
                                       and last["n_tokens"] == n)


def test_stream_matches_the_reference_engine(served):
    """The slice end to end: the port's NDJSON stream for a greedy
    request against the JAX engine's tokens on the same parameters."""
    from rafiki_tpu.models import JaxTransformerLM

    worker, app = served
    prompt = np.random.default_rng(31).integers(0, 512, 21).tolist()
    frames = _stream(app.url, {"tokens": prompt, "max_new": 8})
    _check_stream(frames, 8)
    assert {f["worker_id"] for f in frames} == {worker.worker_id}

    jm = JaxTransformerLM(**JaxTransformerLM.validate_knobs(TINY))
    jm.load_parameters(_params())
    jg = jm.make_generator(**ENGINE)
    try:
        sid, tok = jg.admit(prompt, max_new=8, temperature=0.0)
        ref, gaps = [tok], []
        for _ in range(7):
            top2 = np.sort(np.asarray(jg.last_logits[sid]))[-2:]
            gaps.append(top2[1] - top2[0])
            (r,), _ = jg.step()
            ref.append(r[1])
    finally:
        jg.close()
        jm.destroy()
    got = _tokens(frames)
    for i, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            assert min(gaps[:i + 1]) < NEAR_TIE, f"token {i} differs"
            break


def test_stream_end_to_end_and_prefix_reuse(served):
    worker, app = served
    prompt = np.random.default_rng(23).integers(0, 512, size=9).tolist()
    frames = _stream(app.url, {"tokens": prompt, "max_new": 6})
    _check_stream(frames, 6)
    assert frames[-1]["finish"] == "length"
    # The same prompt again: the same greedy tokens, and the engine's
    # prefix cache skips the second prefill.
    sched = worker.scheduler
    skipped0 = sched.engine.prefill_skipped_total
    frames2 = _stream(app.url, {"tokens": prompt, "max_new": 6})
    assert _tokens(frames2) == _tokens(frames)
    assert sched.engine.prefill_skipped_total == skipped0 + 1
    st = sched.stats()
    assert st["prefills_cached"] >= 1 and st["errors"] == 0
    assert st["served"] >= 2 and st["tokens"] >= 12
    assert st["decode_dispatches"] >= 10 and len(st["ttft_s"]) >= 2


def test_eos_ends_the_stream(served):
    _, app = served
    prompt = np.random.default_rng(23).integers(0, 512, size=9).tolist()
    toks = _tokens(_stream(app.url, {"tokens": prompt, "max_new": 6}))
    frames = _stream(app.url, {"tokens": prompt, "max_new": 6,
                               "eos": toks[2]})
    first = toks.index(toks[2])
    assert frames[-1]["finish"] == "eos"
    assert _tokens(frames) == toks[:first + 1]


def test_concurrent_streams_all_finish(served):
    worker, app = served
    rng = np.random.default_rng(37)
    bodies = [{"tokens": rng.integers(0, 512, int(n)).tolist(),
               "max_new": int(m), "temperature": t, "seed": i}
              for i, (n, m, t) in enumerate(zip(
                  rng.integers(1, 40, 6), rng.integers(2, 12, 6),
                  [0.0, 0.8] * 3))]
    out = [None] * len(bodies)

    def one(i):
        out[i] = _stream(app.url, bodies[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for body, frames in zip(bodies, out):
        _check_stream(frames, body["max_new"])
    # More streams than lanes: requests waited at the gate and joined
    # between steps.
    assert worker.scheduler.engine.decode_batch < len(bodies)


@pytest.mark.parametrize("body", [{}, {"tokens": []}, {"tokens": 3},
                                  {"tokens": [1], "max_new": "x"},
                                  {"tokens": [1, "a"]},
                                  {"tokens": [1], "eos": []}])
def test_bad_bodies_get_400(served, body):
    _, app = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(app.url + "/generate", body)
    assert e.value.code == 400
    e.value.close()


def test_503_without_a_generating_worker():
    worker = InferenceWorker(TorchTransformerLM, KNOBS, _params(),
                             device="cpu").start()
    app = PredictorService([worker], device="cpu").start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(app.url + "/generate", {"tokens": [1], "max_new": 2})
        assert e.value.code == 503
        e.value.close()
        # The worker itself answers a generate request with an error
        # frame.
        qid = worker.generate([1, 2], max_new=2)
        (fr,) = worker.frames.pop_token_frames(qid, timeout=1.0)
        assert fr["done"] and fr["finish"] == "error"
    finally:
        app.stop()
        worker.stop()


class _Unloaded(TorchTransformerLM):
    """A model whose load_parameters installs nothing."""

    def load_parameters(self, params):
        pass


def test_worker_asked_to_generate_without_parameters_raises():
    with pytest.raises(RuntimeError, match="load_parameters"):
        InferenceWorker(_Unloaded, KNOBS, _params(), device="cpu",
                        generate=ENGINE)


def test_worker_asked_to_generate_a_model_that_cannot_raises():
    from rafiki_torch.model.base import BaseModel

    class Scorer(BaseModel):
        """A model that scores but has no generation engine."""

        def __init__(self, device=None, **knobs):
            super().__init__(**knobs)

        @staticmethod
        def get_knob_config():
            return {}

        def train(self, dataset_path, **kwargs):
            pass

        def evaluate(self, dataset_path):
            return 0.0

        def predict(self, queries):
            return [0.0 for _ in queries]

        def dump_parameters(self):
            return {}

        def load_parameters(self, params):
            pass

    with pytest.raises(TypeError, match="make_generator"):
        InferenceWorker(Scorer, {}, {}, device="cpu", generate=ENGINE)


# ---- the scheduler on its own ---------------------------------------


@pytest.fixture()
def sched():
    m = TorchTransformerLM(device="cpu",
                           **TorchTransformerLM.validate_knobs(TINY))
    m.load_parameters(_params())
    frames = TokenFrames()
    s = DecodeScheduler(m.make_generator(**ENGINE), frames, "w1",
                        idle_wait=0.005)
    t = threading.Thread(target=s.loop, daemon=True)
    t.start()
    yield s, frames
    s.close(join=t)
    assert s.engine.pool.used_pages == 0


def _submit(s, qid, tokens, **gen):
    s.submit({"query_id": qid, "op": "generate",
              "gen": dict(tokens=tokens, **gen)})


def _collect(frames, qid, n=None, timeout=60.0):
    out = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out.extend(frames.pop_token_frames(qid, timeout=0.1))
        if (out and out[-1]["done"]) or (n is not None and len(out) >= n):
            return out
    raise AssertionError(f"stream {qid} did not finish: {out}")


def test_short_request_finishes_while_long_decodes(sched):
    s, frames = sched
    rng = np.random.default_rng(29)
    _submit(s, "long", rng.integers(0, 512, 8).tolist(), max_new=14)
    first = _collect(frames, "long", n=1)
    _submit(s, "short", rng.integers(0, 512, 5).tolist(), max_new=3)
    short = _collect(frames, "short")
    assert short[-1]["finish"] == "length"
    assert len(_tokens(short)) == 3
    # The long stream was still going when the short one finished.
    assert not first[-1]["done"]
    rest = _collect(frames, "long")
    assert len(_tokens(first + rest)) == 14
    seqs = [f["seq"] for f in first + rest]
    assert seqs == list(range(len(seqs)))


def test_malformed_request_answers_error_frame(sched):
    s, frames = sched
    s.submit({"query_id": "bad-1", "gen": {"tokens": []}})
    (fr,) = _collect(frames, "bad-1", timeout=5.0)
    assert fr["finish"] == "error" and fr["done"]
    assert fr["worker_id"] == "w1" and fr["n_tokens"] == 0
    s.submit({"gen": {"tokens": [1]}})      # no query id: dropped
    assert s.errors_total == 0


@pytest.mark.parametrize("tokens", [[1, 512], [-1, 3]])
def test_out_of_vocabulary_ids_fail_admission(sched, tokens):
    """An id outside the embedding table never reaches the device: the
    engine refuses the prompt and the stream gets an error frame; a
    later request is served as usual."""
    s, frames = sched
    _submit(s, "oov", tokens, max_new=3)
    (fr,) = _collect(frames, "oov", timeout=10.0)
    assert fr["finish"] == "error" and fr["error"] == "admission failed"
    _submit(s, "ok", [1, 2, 3], max_new=3, seed=2 ** 70, temperature=0.8)
    assert _collect(frames, "ok")[-1]["finish"] == "length"


def test_preempted_stream_resumes_with_contiguous_frames():
    """A pool too small for both sequences: the youngest is preempted,
    re-queued at the front with its token trail and frame numbering,
    and both streams finish with every token."""
    m = TorchTransformerLM(device="cpu",
                           **TorchTransformerLM.validate_knobs(TINY))
    m.load_parameters(_params())
    frames = TokenFrames()
    s = DecodeScheduler(m.make_generator(page_size=4, n_pages=6,
                                         decode_batch=2, max_new_cap=16,
                                         prefix_cache_entries=0),
                        frames, "w1", idle_wait=0.005)
    rng = np.random.default_rng(17)
    _submit(s, "a", rng.integers(0, 512, 4).tolist(), max_new=12)
    _submit(s, "b", rng.integers(0, 512, 4).tolist(), max_new=12)
    t = threading.Thread(target=s.loop, daemon=True)
    t.start()
    try:
        for qid in ("a", "b"):
            out = _collect(frames, qid)
            assert [f["seq"] for f in out] == list(range(len(out)))
            assert out[-1]["finish"] == "length"
            assert out[-1]["n_tokens"] == len(_tokens(out)) == 12
        assert s.stats()["preemptions"] >= 1
        assert s.engine.evictions_total >= 1
    finally:
        s.close(join=t)


# ---- the chunked reply ----------------------------------------------


def test_stream_response_reaches_the_client_before_it_ends():
    """The first chunk arrives while the generator is still waiting to
    produce the last one; a client that leaves mid-stream ends the
    iteration and the generator's ``finally`` runs."""
    gate = threading.Event()
    finished = []

    def handler(body):
        def chunks():
            try:
                yield json.dumps({"n": 0}) + "\n"
                assert gate.wait(timeout=10.0)
                for i in range(1, 1000):
                    yield json.dumps({"n": i}) + "\n"
                    time.sleep(0.001)
            finally:
                finished.append(True)
        return 200, StreamResponse("application/x-ndjson", chunks())

    http = JsonHttpServer([("POST", "/s", handler)]).start()
    try:
        url = f"http://{http.host}:{http.port}/s"
        with _post(url, {}) as resp:
            assert json.loads(resp.readline()) == {"n": 0}
            gate.set()
            assert json.loads(resp.readline()) == {"n": 1}
        # The client closed after two lines: the writer hits a broken
        # pipe and closes the generator.
        deadline = time.monotonic() + 10.0
        while not finished and time.monotonic() < deadline:
            time.sleep(0.01)
        assert finished == [True]
    finally:
        http.stop()


def test_generate_times_out_with_a_final_line():
    class Silent:
        """A generating worker whose frames never come."""
        device = __import__("torch").device("cpu")
        generates = True
        frames = TokenFrames()

        def generate(self, tokens, **kw):
            return "q-silent"

        def submit(self, queries):
            raise AssertionError("not used")

    app = PredictorService([Silent()], device="cpu", timeout=0.5).start()
    try:
        frames = _stream(app.url, {"tokens": [1, 2], "max_new": 4})
        assert frames == [{"done": True, "finish": "timeout"}]
    finally:
        app.stop()


def test_token_frames_under_contention():
    """Many senders and one popper per query, the interpreter switching
    threads often: every frame arrives once, in each sender's order."""
    import sys

    tf = TokenFrames()
    n_q, n_send, n_frames = 4, 8, 200
    got = {q: [] for q in range(n_q)}

    def send(q, w):
        for i in range(n_frames):
            tf.send_token_frame(f"q{q}", f"w{w}", {"seq": i})

    def pop(q):
        while len(got[q]) < n_send * n_frames:
            got[q].extend(tf.pop_token_frames(f"q{q}", timeout=1.0))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = ([threading.Thread(target=pop, args=(q,))
                    for q in range(n_q)]
                   + [threading.Thread(target=send, args=(q, w))
                      for q in range(n_q) for w in range(n_send)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    for q in range(n_q):
        assert len(got[q]) == n_send * n_frames
        for w in range(n_send):
            assert [f["seq"] for f in got[q]
                    if f["worker_id"] == f"w{w}"] == list(range(n_frames))
    assert tf.pop_token_frames("q0", timeout=0.01) == []


def test_token_frames_queue_per_query():
    tf = TokenFrames()
    assert tf.pop_token_frames("q", timeout=0.01) == []
    tf.send_token_frame("q", "w", {"seq": 0, "tok": [5], "done": False})
    tf.send_token_frame("r", "w", {"seq": 0, "tok": [6], "done": True})
    tf.send_token_frame("q", "w", {"seq": 1, "tok": [7], "done": True})
    assert tf.pop_token_frames("q") == [
        {"seq": 0, "tok": [5], "done": False, "worker_id": "w"},
        {"seq": 1, "tok": [7], "done": True, "worker_id": "w"}]
    assert tf.pop_token_frames("q", timeout=0.01) == []
    assert [f["tok"] for f in tf.pop_token_frames("r")] == [[6]]
    # A frame pushed from another thread wakes a waiting pop.
    threading.Timer(0.05, tf.send_token_frame,
                    ("q", "w", {"seq": 2, "tok": [], "done": True})).start()
    assert tf.pop_token_frames("q", timeout=5.0)[0]["seq"] == 2
