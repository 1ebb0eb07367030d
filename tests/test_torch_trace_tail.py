"""The port's trace store (``rafiki_torch.observe.trace``) held against
the reference's, on the CPU: tail sampling and its verdicts, the
remote hold, the sidecar indexes, the active segment's scan cache and
compaction.

Both packages get the same inputs: the same span lines (trace and span
ids drawn from one counter, start times given), the same durations
under the same ``seed_tail``. Everything they write must be equal byte
for byte (segments, ``.idx`` sidecars, ``trace_verdicts.jsonl``), and
every read (``collect_trace``, verdict counts, ``exemplar_ok``) equal
as values. Tolerance: none, the store is exact.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import itertools
import json
import os

import pytest

from rafiki_tpu.observe import metrics as ref_metrics
from rafiki_tpu.observe import trace as ref_trace
from rafiki_torch.observe import metrics as port_metrics
from rafiki_torch.observe import trace as port_trace

PACKAGES = {"ref": (ref_trace, ref_metrics),
            "port": (port_trace, port_metrics)}
VERDICTS = ("kept_error", "kept_slow", "kept_sampled", "dropped")


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    """Both trace modules pointed at their own log directory, with
    trace and span ids drawn from counters that start alike, tail state
    cleared. Yields {kind: (trace module, metrics module, log dir)}."""
    out = {}
    for kind, (tr, me) in PACKAGES.items():
        log_dir = str(tmp_path / kind)
        os.makedirs(log_dir)
        tids = itertools.count(1)
        sids = itertools.count(1)
        monkeypatch.setattr(tr, "new_trace_id",
                            lambda c=tids: f"{next(c):032x}")
        monkeypatch.setattr(tr, "new_span_id",
                            lambda c=sids: f"{next(c):016x}")
        tr.reset_tail_for_tests()
        tr.configure(log_dir)
        out[kind] = (tr, me, log_dir)
    try:
        yield out
    finally:
        for tr, _, _ in out.values():
            tr.configure(None)
            tr.reset_tail_for_tests()


def _files(log_dir):
    """Every file of a log directory, name -> bytes."""
    out = {}
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name), "rb") as f:
            out[name] = f.read()
    return out


def _tail_counts(me):
    c = me.registry().find("rafiki_tpu_trace_tail_total")
    if c is None:
        return {}
    return {labels["verdict"]: v for labels, v in c.samples()}


def _run_requests(tr, me, durations, errors, seed):
    """Mint one tail trace a request, record an edge span and a child
    span under it, give its verdict; returns the verdict of each."""
    tr.seed_tail(seed)
    verdicts = []
    for i, (dur, err) in enumerate(zip(durations, errors)):
        before = _tail_counts(me)
        ctx = tr.start_trace()
        assert ctx is not None and ctx.tail
        wall = 1_700_000_000.0 + i
        tr.record_event("worker.predict", "w", [ctx], wall + 0.001,
                        dur / 2)
        tr.record_event("http POST /predict", "p", [ctx], wall, dur,
                        attrs={"status": 500 if err else 200},
                        child=False)
        tr.complete(ctx, dur, error=err)
        after = _tail_counts(me)
        changed = [v for v in VERDICTS
                   if after.get(v, 0) != before.get(v, 0)]
        assert len(changed) == 1
        verdicts.append((ctx.trace_id, changed[0]))
    return verdicts


DURATIONS = [0.010, 0.300, 0.020, 0.005, 0.600, 0.030, 0.002, 0.015,
             0.001, 0.040, 0.012, 0.008]
ERRORS = [False, False, True, False, False, False, False, True, False,
          False, False, False]


def test_tail_verdicts_repeat_under_one_seed(stores, monkeypatch):
    monkeypatch.setenv("RAFIKI_TPU_TRACE_TAIL_SAMPLE", "0.4")
    monkeypatch.setenv("RAFIKI_TPU_TRACE_TAIL_SLOW_MS", "250")
    seen = {kind: _run_requests(tr, me, DURATIONS, ERRORS, seed=11)
            for kind, (tr, me, _) in stores.items()}
    assert seen["port"] == seen["ref"]
    kinds = {v for _, v in seen["port"]}
    assert kinds == set(VERDICTS), kinds  # every verdict met once at least
    # Errors and slow requests are kept whatever the draw.
    for (tid, v), dur, err in zip(seen["port"], DURATIONS, ERRORS):
        if err:
            assert v == "kept_error"
        elif dur >= 0.25:
            assert v == "kept_slow"
    for kind, (tr, me, log_dir) in stores.items():
        lines = [json.loads(x) for x in open(
            os.path.join(log_dir, tr.VERDICT_FILE))]
        # One verdict line a minted trace.
        assert [x["t"] for x in lines] == [t for t, _ in seen[kind]]
        for x, (_, v) in zip(lines, seen[kind]):
            assert x["v"] == ("dropped" if v == "dropped" else "kept")
    assert _files(stores["port"][2]) == _files(stores["ref"][2])
    for tid, v in seen["port"]:
        got = {kind: tr.collect_trace(log_dir, tid)
               for kind, (tr, _, log_dir) in stores.items()}
        assert got["port"] == got["ref"]
        assert got["port"]["n_spans"] == (0 if v == "dropped" else 2)


def test_exemplar_ok_agrees(stores, monkeypatch):
    monkeypatch.setenv("RAFIKI_TPU_TRACE_TAIL_SAMPLE", "0.5")
    out = {}
    for kind, (tr, me, _) in stores.items():
        tr.seed_tail(3)
        honoured = tr.start_trace("ab" * 16 + "-" + "cd" * 8)
        pending = tr.start_trace()
        states = [tr.exemplar_ok(honoured), tr.exemplar_ok(pending)]
        done = []
        for _ in range(8):  # until one is dropped and one kept
            ctx = tr.start_trace()
            tr.complete(ctx, 0.001)
            done.append(tr.exemplar_ok(ctx))
        out[kind] = (states, done, honoured.tail, pending.tail)
    assert out["port"] == out["ref"]
    states, done, honoured_tail, pending_tail = out["port"]
    assert states == [True, False] and not honoured_tail and pending_tail
    assert True in done and False in done


def test_envelope_tail_marks_and_the_remote_hold(stores, monkeypatch):
    """A consumer holds the spans of a trace minted in another process
    (the envelope's tail marks) until the verdict file speaks: a dropped
    verdict suppresses them, a kept one writes them, no verdict within
    the hold keeps them."""
    monkeypatch.setenv("RAFIKI_TPU_TRACE_TAIL_SAMPLE", "0.5")
    results = {}
    for kind, (tr, me, log_dir) in stores.items():
        ctxs = [tr.TraceContext(f"{i:032x}", span_id=f"{i:016x}",
                                tail=True) for i in (101, 102, 103)]
        ctxs.append(tr.TraceContext(f"{104:032x}", span_id=f"{104:016x}"))
        env = tr.inject(ctxs)
        frame = {"queries": [1], tr.ENVELOPE_KEY: json.loads(
            json.dumps(env))}
        got = tr.extract(frame)
        assert tr.ENVELOPE_KEY not in frame
        for i, ctx in enumerate(got):
            tr.record_event("worker.predict", "w", [ctx],
                            1_700_000_100.0 + i, 0.001)
        held = sorted(tr._remote_pending)
        with open(os.path.join(log_dir, tr.VERDICT_FILE), "a") as f:
            f.write(json.dumps({"t": got[0].trace_id, "v": "dropped"})
                    + "\n")
            f.write(json.dumps({"t": got[1].trace_id, "v": "kept"})
                    + "\n")
        tr.flush_remote_expired()
        still = sorted(tr._remote_pending)
        tr.flush_remote_tail()  # the third: no verdict, kept on doubt
        counts = {tid: tr.collect_trace(log_dir, tid)["n_spans"]
                  for tid in (c.trace_id for c in got)}
        results[kind] = (env, held, still, counts, _tail_counts(me))
    assert results["port"] == results["ref"]
    env, held, still, counts, _ = results["port"]
    assert env["tail"] == [0, 1, 2]
    assert held == [f"{i:032x}" for i in (101, 102, 103)]
    assert still == [f"{103:032x}"]
    assert counts == {f"{101:032x}": 0, f"{102:032x}": 1,
                      f"{103:032x}": 1, f"{104:032x}": 1}


def _lines(n, start=0):
    """n span lines over a few trace ids, as record_event writes them."""
    out = []
    for i in range(start, start + n):
        rec = {"trace_id": f"{i % 5:032x}", "span_id": f"{i:016x}",
               "parent_id": None, "name": f"s{i}", "service": "x",
               "start_s": 1_700_000_000.0 + i, "dur_ms": 1.0}
        out.append(json.dumps(rec, separators=(",", ":")) + "\n")
    return out


def test_index_and_compaction_write_the_references_bytes(stores):
    segs = {}
    for kind, (tr, _, log_dir) in stores.items():
        tr.configure(None)
        seg = os.path.join(log_dir, "spans.jsonl.1")
        with open(seg, "w") as f:
            f.writelines(_lines(40))
        offsets = tr._build_index(seg)
        assert tr._load_index_data(seg)["traces"] == offsets
        assert not tr.segment_compacted(seg)
        before = tr.collect_trace(log_dir, f"{2:032x}")
        report = tr.compact_segment(seg, dropped={f"{1:032x}",
                                                  f"{3:032x}"})
        after = {i: tr.collect_trace(log_dir, f"{i:032x}")
                 for i in range(5)}
        segs[kind] = (offsets, before, report, after, _files(log_dir),
                      tr.segment_compacted(seg))
    assert segs["port"] == segs["ref"]
    offsets, before, report, after, files, compacted = segs["port"]
    assert compacted and report["removed"] == 16 and report["kept"] == 24
    assert after[1]["n_spans"] == after[3]["n_spans"] == 0
    assert after[2]["spans"] == before["spans"]
    assert [d["mode"] for d in after[2]["segments"]] == ["index"]
    assert set(files) == {"spans.jsonl.1", "spans.jsonl.1.idx"}


def test_a_stale_index_is_rebuilt(stores):
    """An index whose recorded size is not its segment's (a compaction
    caught between its two replaces) reads as missing, so the lookup
    rebuilds it from the segment it has."""
    got = {}
    for kind, (tr, _, log_dir) in stores.items():
        tr.configure(None)
        seg = os.path.join(log_dir, "spans.jsonl.1")
        with open(seg, "w") as f:
            f.writelines(_lines(10))
        tr._build_index(seg)
        with open(seg, "a") as f:
            f.writelines(_lines(5, start=10))
        assert tr._load_index_data(seg) is None
        res = tr.collect_trace(log_dir, f"{0:032x}")
        got[kind] = (res, _files(log_dir))
    assert got["port"] == got["ref"]
    res = got["port"][0]
    assert res["n_spans"] == 3
    assert res["segments"][0]["mode"] == "index_rebuilt"


def test_the_active_segment_reads_only_its_new_tail(stores):
    got = {}
    for kind, (tr, _, log_dir) in stores.items():
        tr.configure(None)
        path = os.path.join(log_dir, "spans.jsonl")
        with open(path, "w") as f:
            f.writelines(_lines(10))
        first = tr.collect_trace(log_dir, f"{0:032x}")
        again = tr.collect_trace(log_dir, f"{1:032x}")
        with open(path, "a") as f:
            f.writelines(_lines(5, start=10))
        grown = tr.collect_trace(log_dir, f"{0:032x}")
        # Another writer rolled the file: a new inode, already longer
        # than the cache's position. The cache must start over.
        tmp = path + ".new"
        with open(tmp, "w") as f:
            f.writelines(_lines(20, start=100))
        os.replace(tmp, path)
        replaced = tr.collect_trace(log_dir, f"{0:032x}")
        got[kind] = (first, again, grown, replaced)
    assert got["port"] == got["ref"]
    first, again, grown, replaced = got["port"]
    assert first["n_spans"] == 2 and first["segments"][0]["mode"] == \
        "scan_tail"
    # A warm repeat reads its own lines and nothing of the scan.
    own = [x for x in _lines(10) if f'"{1:032x}"' in x]
    assert again["segments"][0]["bytes_read"] == sum(map(len, own))
    assert grown["n_spans"] == 3
    tail = sum(len(x) for x in _lines(5, start=10))
    spans = sum(len(x) for x in _lines(15) if f'"{0:032x}"' in x)
    assert grown["segments"][0]["bytes_read"] == tail + spans
    assert [s["name"] for s in replaced["spans"]] == \
        [f"s{i}" for i in range(100, 120) if i % 5 == 0]


def test_rolls_index_and_compact_as_the_reference(stores, monkeypatch):
    """A store small enough to roll many times under tail sampling:
    each roll writes the frozen segment's index, and a later roll
    compacts an older generation (never .1 or .2), removing the lines
    of dropped traces. Both packages end with the same files."""
    monkeypatch.setenv("RAFIKI_TPU_TRACE_TAIL_SAMPLE", "0.3")
    monkeypatch.setenv("RAFIKI_TPU_TRACE_MAX_MB", str(2048 / 2 ** 20))
    monkeypatch.setenv("RAFIKI_TPU_TRACE_RETAIN_SEGMENTS", "6")
    durations = [0.001 * (1 + i % 7) for i in range(60)]
    errors = [i % 11 == 0 for i in range(60)]
    seen = {}
    for kind, (tr, me, log_dir) in stores.items():
        seen[kind] = _run_requests(tr, me, durations, errors, seed=5)
    assert seen["port"] == seen["ref"]
    assert _files(stores["port"][2]) == _files(stores["ref"][2])
    files = _files(stores["port"][2])
    assert "spans.jsonl.3.idx" in files
    compacted = [n for n, b in files.items()
                 if n.endswith(".idx") and json.loads(b)["compacted"]]
    assert compacted and not {"spans.jsonl.1.idx",
                              "spans.jsonl.2.idx"} & set(compacted)
    for tid, v in seen["port"]:
        got = {kind: tr.collect_trace(log_dir, tid)
               for kind, (tr, _, log_dir) in stores.items()}
        assert got["port"] == got["ref"]
