"""The port's host dataset cache, its loaders and the zip-of-PNG format
against the JAX package's on the CPU.

Each cache test drives both packages the same way and compares what
they keep, in what order, and what they count; each format test has
each package read what the other wrote. Exact throughout: the cache
holds no numbers of its own, and the formats are bytes.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import os
import threading

import numpy as np
import pytest

from rafiki_torch import config as pconfig
from rafiki_torch.model import dataset as pds
from rafiki_torch.observe import phases as pphases
from rafiki_tpu import config as rconfig
from rafiki_tpu.model import dataset as rds
from rafiki_tpu.observe import phases as rphases

PACKAGES = ((pds, pphases), (rds, rphases))


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    for env in (pds.DATASET_CACHE_ENV, "RAFIKI_TPU_STAGE_CACHE_BYTES",
                "RAFIKI_TPU_STAGE_BYTES"):
        monkeypatch.delenv(env, raising=False)
    pds.clear_dataset_cache()
    rds.clear_dataset_cache()
    yield
    pds.clear_dataset_cache()
    rds.clear_dataset_cache()


def _images(seed=0, n=12, shape=(6, 5, 3)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, *shape)).astype(np.uint8),
            rng.integers(0, 4, n).astype(np.int64))


def _ops(seed):
    """A seeded sequence of puts (key, bytes, budget, owner) and gets."""
    rng = np.random.default_rng(seed)
    owners = (None, "job-a", "job-b", "job-c")
    ops = []
    for _ in range(80):
        key = int(rng.integers(0, 10))
        if rng.random() < 0.3:
            ops.append(("get", key))
        else:
            ops.append(("put", key, int(rng.integers(10, 160)),
                        int(rng.choice([150, 300, 450])),
                        owners[int(rng.integers(0, 4))]))
    return ops


def _drive(mod, phases, ops):
    lru = mod.ByteBudgetLRU("stage")
    evicts0 = phases.cache_counts("stage").get("evict", 0)
    trace = []
    for op in ops:
        got = None
        if op[0] == "put":
            _, key, nbytes, budget, owner = op
            with mod.stage_owner(owner):
                lru.put(key, f"value-{key}-{nbytes}", nbytes, budget)
        else:
            got = lru.get(op[1])
        trace.append((list(lru._entries), [e[2] for e in
                                           lru._entries.values()],
                      lru.info(), got,
                      phases.cache_counts("stage").get("evict", 0)
                      - evicts0))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_lru_keeps_and_evicts_as_the_reference(seed):
    """Entries left, their order and owners, the bytes held, what a get
    returns and the evictions counted, after every step."""
    ops = _ops(seed)
    port, ref = (_drive(mod, ph, ops) for mod, ph in PACKAGES)
    assert port == ref
    assert port[-1][4] > 0  # the sequence did evict


def test_an_eviction_takes_another_owners_entry_first():
    for mod, _ in PACKAGES:
        lru = mod.ByteBudgetLRU("stage")
        with mod.stage_owner("a"):
            lru.put("a1", 1, 10, 30)
            lru.put("a2", 2, 10, 30)
        with mod.stage_owner("b"):
            lru.put("b1", 3, 10, 30)
        with mod.stage_owner("a"):
            lru.put("a3", 4, 10, 30)
        assert list(lru._entries) == ["a1", "a2", "a3"]
        lru.put("x", 5, 10, 30)  # unowned: every owned entry is foreign
        assert list(lru._entries) == ["a2", "a3", "x"]


def test_hits_return_the_same_object(tmp_path):
    imgs, labels = _images()
    path = pds.write_image_dataset_npz(imgs, labels, str(tmp_path / "a"))
    for mod, _ in PACKAGES:
        a = mod.load_image_dataset(path)
        assert mod.load_image_dataset(path) is a
        assert a.fingerprint == mod.dataset_fingerprint(path)
    assert pds.dataset_fingerprint(path) == rds.dataset_fingerprint(path)


@pytest.mark.parametrize("change", ["size", "mtime"])
def test_a_rewritten_file_is_a_miss(tmp_path, change):
    path = str(tmp_path / "t.npz")
    for mod, phases in PACKAGES:
        pds.write_token_dataset(np.arange(40) % 7, 7, path)
        first = mod.load_token_dataset(path)
        counts0 = phases.cache_counts("dataset")
        if change == "size":
            pds.write_token_dataset(np.arange(90) % 7, 7, path)
        else:
            st = os.stat(path)
            os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
        again = mod.load_token_dataset(path)
        counts = phases.cache_counts("dataset")
        assert again is not first
        assert counts.get("miss", 0) - counts0.get("miss", 0) == 1
        assert again.size == (90 if change == "size" else 40)
        mod.clear_dataset_cache()


def test_budget_zero_disables_and_an_oversized_set_is_not_kept(
        tmp_path, monkeypatch):
    imgs, labels = _images()
    path = pds.write_image_dataset_npz(imgs, labels, str(tmp_path / "a"))
    nbytes = imgs.nbytes + labels.nbytes
    for mod, phases in PACKAGES:
        monkeypatch.setenv(mod.DATASET_CACHE_ENV, "0")
        a, b = mod.load_image_dataset(path), mod.load_image_dataset(path)
        assert a is not b and a.images.flags.writeable
        assert a.fingerprint == mod.dataset_fingerprint(path)
        monkeypatch.setenv(mod.DATASET_CACHE_ENV, str(nbytes - 1))
        c0 = phases.cache_counts("dataset").get("miss", 0)
        a, b = mod.load_image_dataset(path), mod.load_image_dataset(path)
        assert a is not b
        assert phases.cache_counts("dataset")["miss"] - c0 == 2
        assert mod._DATASET_CACHE.info() == {"entries": 0, "bytes": 0}
        monkeypatch.setenv(mod.DATASET_CACHE_ENV, str(nbytes))
        assert mod.load_image_dataset(path) is mod.load_image_dataset(path)
        assert mod._DATASET_CACHE.info() == {"entries": 1, "bytes": nbytes}


def test_the_budget_is_read_per_call_and_defaults_as_the_reference(
        monkeypatch):
    assert pds.DATASET_CACHE_ENV == rds.DATASET_CACHE_ENV
    assert pds.DATASET_CACHE_DEFAULT == rds.DATASET_CACHE_DEFAULT == 1 << 30
    for raw in ("5", "junk", None):
        if raw is None:
            monkeypatch.delenv(pds.DATASET_CACHE_ENV, raising=False)
        else:
            monkeypatch.setenv(pds.DATASET_CACHE_ENV, raw)
        assert pds.dataset_cache_budget() == rds.dataset_cache_budget()


def test_cached_arrays_are_frozen(tmp_path):
    imgs, labels = _images()
    img_path = pds.write_image_dataset_npz(imgs, labels, str(tmp_path / "a"))
    tab_path = pds.write_tabular_dataset(np.ones((4, 2)), np.arange(4),
                                         str(tmp_path / "t.csv"))
    tok_path = pds.write_token_dataset(np.arange(9), 9, str(tmp_path / "k"))
    for mod, _ in PACKAGES:
        ds = mod.load_image_dataset(img_path)
        tab = mod.load_tabular_dataset(tab_path)
        tok = mod.load_token_dataset(tok_path)
        for arr in (ds.images, ds.labels, tab.features, tab.targets,
                    tok.ids):
            with pytest.raises(ValueError, match="read-only"):
                arr[0] = 0


def test_tabular_entries_are_keyed_by_the_label_column(tmp_path):
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    path = pds.write_tabular_dataset(x, np.arange(6) % 2,
                                     str(tmp_path / "t.csv"))
    got = []
    for mod, _ in PACKAGES:
        last = mod.load_tabular_dataset(path)
        by_f0 = mod.load_tabular_dataset(path, label_col="f0")
        assert by_f0 is not last
        assert mod.load_tabular_dataset(path, label_col="f0") is by_f0
        assert mod.load_tabular_dataset(path) is last
        assert mod._DATASET_CACHE.info()["entries"] == 2
        got.append((last.target_name, by_f0.target_name,
                    by_f0.features.tolist(), by_f0.n_classes))
    assert got[0] == got[1]


def test_the_corpus_loader_is_not_cached(tmp_path):
    path = pds.write_corpus_dataset([["a", "b"]], [["N", "V"]],
                                    str(tmp_path / "c.zip"))
    for mod, _ in PACKAGES:
        assert mod.load_corpus_dataset(path) is not \
            mod.load_corpus_dataset(path)
        assert mod.load_dataset_of_corpus is mod.load_corpus_dataset
        assert mod._DATASET_CACHE.info()["entries"] == 0


def test_stage_owner_is_thread_local_and_nests():
    for mod, _ in PACKAGES:
        seen = {}
        inside = threading.Event()
        release = threading.Event()

        def other():
            seen["before"] = mod.current_stage_owner()
            with mod.stage_owner("b"):
                inside.set()
                release.wait(10)
                seen["inside"] = mod.current_stage_owner()
            seen["after"] = mod.current_stage_owner()

        with mod.stage_owner("a"):
            t = threading.Thread(target=other)
            t.start()
            assert inside.wait(10)
            assert mod.current_stage_owner() == "a"
            with mod.stage_owner("c"):
                assert mod.current_stage_owner() == "c"
            assert mod.current_stage_owner() == "a"
            release.set()
            t.join(10)
        assert not t.is_alive()
        assert mod.current_stage_owner() is None
        assert seen == {"before": None, "inside": "b", "after": None}


def test_events_and_the_bytes_gauge_count_as_the_reference(tmp_path):
    imgs, labels = _images()
    a = pds.write_image_dataset_npz(imgs, labels, str(tmp_path / "a"))
    b = pds.write_image_dataset_npz(*_images(1), str(tmp_path / "b"))
    got = []
    for mod, phases in PACKAGES:
        c0 = phases.cache_counts("dataset")
        for path in (a, b, a, a, b):
            mod.load_image_dataset(path)
        c1 = phases.cache_counts("dataset")
        gauge = phases._reg()["dataset_cache_bytes"].samples()
        got.append(({e: c1.get(e, 0) - c0.get(e, 0) for e in
                     ("hit", "miss", "evict")}, gauge))
        mod.clear_dataset_cache()
        assert phases._reg()["dataset_cache_bytes"].samples()[0][1] == 0
    assert got[0] == got[1]
    assert got[0][0] == {"hit": 3, "miss": 2, "evict": 0}
    assert got[0][1][0][1] == 2 * (imgs.nbytes + labels.nbytes)


def test_the_loaders_read_as_the_reference(tmp_path):
    imgs, labels = _images(2, shape=(4, 4))  # grayscale without a channel
    img = pds.write_image_dataset_npz(imgs, labels, str(tmp_path / "g"))
    tok = pds.write_token_dataset(np.arange(50) % 11, 11,
                                  str(tmp_path / "k"))
    x = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    tab = pds.write_tabular_dataset(x, np.linspace(0, 1, 8),
                                    str(tmp_path / "r.csv"))
    p, r = pds.load_image_dataset(img), rds.load_image_dataset(img)
    assert p.images.shape == (12, 4, 4, 1)
    assert np.array_equal(p.images, r.images) and \
        np.array_equal(p.labels, r.labels) and p.n_classes == r.n_classes
    assert np.array_equal(pds.load_token_dataset(tok).ids,
                          rds.load_token_dataset(tok).ids)
    pt, rt = pds.load_tabular_dataset(tab), rds.load_tabular_dataset(tab)
    assert np.array_equal(pt.features, rt.features)
    assert np.array_equal(pt.targets, rt.targets) and pt.n_classes is None


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 1), (6, 4, 3)])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_zip_of_png_reads_back_in_both_packages(tmp_path, shape, writer):
    """Each package reads the other's zip of PNGs to the same arrays,
    grayscale (with or without a channel axis) and RGB."""
    pytest.importorskip("PIL")
    imgs, labels = _images(3, n=9, shape=shape)
    mod = pds if writer == "port" else rds
    path = mod.write_image_files_dataset(imgs, labels,
                                         str(tmp_path / "set.zip"))
    want = imgs if imgs.ndim == 4 else imgs[..., None]
    for reader in (pds, rds):
        ds = reader.load_dataset_of_image_files(path)
        assert np.array_equal(ds.images, want)
        assert np.array_equal(ds.labels, labels)
        assert ds.n_classes == int(labels.max()) + 1


def test_normalized_and_batches_are_the_reference(tmp_path):
    imgs, labels = _images(4, n=11)
    p = pds.ImageDataset(imgs, labels, 4)
    r = rds.ImageDataset(imgs, labels, 4)
    assert np.array_equal(p.normalized(), r.normalized())
    assert p.normalized(np.float64).dtype == np.float64
    for kw in ({}, {"shuffle": True, "seed": 5},
               {"drop_remainder": True, "shuffle": True}):
        got = list(p.batches(4, **kw))
        want = list(r.batches(4, **kw))
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


CACHE_FIELDS = ("dataset_cache_bytes", "stage_cache_bytes", "stage_bytes")


@pytest.mark.parametrize("field", CACHE_FIELDS)
def test_cache_fields_default_and_name_as_the_reference(field):
    assert getattr(pconfig.NodeConfig(), field) == \
        getattr(rconfig.NodeConfig(), field)
    assert pconfig.NodeConfig.env_name(field) == \
        rconfig.NodeConfig.env_name(field)


def test_the_modules_defaults_equal_the_fields():
    from rafiki_torch.model import torch_model

    cfg = pconfig.NodeConfig()
    assert cfg.dataset_cache_bytes == pds.DATASET_CACHE_DEFAULT
    assert cfg.stage_cache_bytes == torch_model.STAGE_CACHE_DEFAULT
    assert cfg.stage_bytes == torch_model.STAGE_BYTES_DEFAULT
    assert torch_model.STAGE_CACHE_ENV == \
        pconfig.NodeConfig.env_name("stage_cache_bytes")
    assert torch_model.STAGE_BYTES_ENV == \
        pconfig.NodeConfig.env_name("stage_bytes")


def _outcome(cls, env, overrides):
    try:
        cfg = cls.from_env(env, **overrides)
    except ValueError as e:
        return ("error", str(e))
    return tuple(getattr(cfg, f) for f in CACHE_FIELDS)


@pytest.mark.parametrize("env,overrides", [
    ({}, {}),
    ({"RAFIKI_TPU_DATASET_CACHE_BYTES": "0"}, {}),
    ({"RAFIKI_TPU_STAGE_CACHE_BYTES": "12345"}, {"stage_bytes": 0}),
    ({}, {"dataset_cache_bytes": -1}),
    ({"RAFIKI_TPU_STAGE_CACHE_BYTES": "-5"}, {}),
    ({}, {"stage_bytes": -1}),
    ({"RAFIKI_TPU_STAGE_BYTES": "nope"}, {}),
])
def test_cache_fields_parse_and_validate_as_the_reference(env, overrides):
    got = [_outcome(cls, env, overrides)
           for cls in (pconfig.NodeConfig, rconfig.NodeConfig)]
    assert got[0] == got[1]


def test_cache_fields_are_exported_as_the_reference():
    saved = dict(os.environ)
    exported = []
    try:
        for cls in (pconfig.NodeConfig, rconfig.NodeConfig):
            cls(dataset_cache_bytes=7, stage_cache_bytes=0,
                stage_bytes=99).apply_env()
            exported.append({f: os.environ.get(cls.env_name(f))
                             for f in CACHE_FIELDS})
            assert pds.dataset_cache_budget() == 7
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert exported[0] == exported[1] == {
        "dataset_cache_bytes": "7", "stage_cache_bytes": "0",
        "stage_bytes": "99"}
