"""Helpers of the port's static-analysis tests: fixture trees, a tmp
copy of the port's tree with textual mutations, and the gate
assertion."""

import os
import re
import shutil

from rafiki_torch.analysis.core import baseline_path, load_baseline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The reference's fixtures, and the port's own (its torch forms).
FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")
TORCH_FIXTURES = os.path.join(REPO, "tests", "torch_analysis_fixtures")
#: The reference's framework-neutral fixture kinds.
KINDS = ["guarded", "thread", "series", "drift", "concurrency", "flow",
         "stale_waiver"]
IMPORT_RE = re.compile(r"^(\s*(?:from|import)\s+)rafiki_tpu\b", re.M)


def fixture_tree(fixture, dst, pkg="rafiki_torch"):
    """A tree of one reference fixture (a file or a tree) at ``dst``,
    its package directory named ``pkg``; for the port, the module
    paths of its imports rewritten (metric names and ``RAFIKI_TPU_*``
    literals stay, as the port keeps them)."""
    src = os.path.join(FIXTURES, fixture)
    if os.path.isdir(src):
        shutil.copytree(src, dst)
        if pkg != "rafiki_tpu":
            os.rename(os.path.join(dst, "rafiki_tpu"),
                      os.path.join(dst, pkg))
    else:
        os.makedirs(os.path.join(dst, pkg))
        shutil.copy(src + ".py", os.path.join(dst, pkg, fixture + ".py"))
    if pkg != "rafiki_tpu":
        for dirpath, _dirs, files in os.walk(os.path.join(dst, pkg)):
            for fn in files:
                if fn.endswith(".py"):
                    path = os.path.join(dirpath, fn)
                    with open(path, encoding="utf-8") as f:
                        text = f.read()
                    with open(path, "w", encoding="utf-8") as f:
                        f.write(IMPORT_RE.sub(r"\g<1>" + pkg, text))
    return dst


def torch_fixture_tree(fixture, dst):
    """A tree of one of the port's own fixtures at ``dst``."""
    src = os.path.join(TORCH_FIXTURES, fixture)
    if os.path.isdir(src):
        shutil.copytree(src, dst)
    else:
        os.makedirs(os.path.join(dst, "rafiki_torch"))
        shutil.copy(src + ".py",
                    os.path.join(dst, "rafiki_torch", fixture + ".py"))
    return dst


def _mutated(tmp_path, edits, docs=False):
    """A copy of the port's tree with ``edits``: {rel: [(old, new)]}."""
    root = tmp_path / "tree"
    shutil.copytree(os.path.join(REPO, "rafiki_torch"),
                    root / "rafiki_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if docs:
        shutil.copytree(os.path.join(REPO, "docs"), root / "docs")
    for rel, reps in edits.items():
        path = root / rel
        text = path.read_text(encoding="utf-8")
        for old, new in reps:
            assert old in text, f"mutation target {old!r} missing in {rel}"
            text = text.replace(old, new)
        path.write_text(text, encoding="utf-8")
    return str(root)


def _assert_bites(report, code, anchor=None, text=None):
    """A new finding of ``code`` (with ``anchor``, and ``text`` in its
    message). The unmutated tree gives none: the real tree has no new
    finding (tests/test_torch_analysis.py), and none of the gates'
    codes is frozen in the baseline."""
    hits = [f for f in report.new if f.code == code
            and (anchor is None or f.anchor == anchor)
            and (text is None or text in f.message)]
    assert hits, [f.render() for f in report.new]
    assert not any(ident.startswith(code + ":")
                   for ident in load_baseline(baseline_path()))
