"""The repo's `huge` rule (conftest.py at the repo root): under `-m`, a
test marked `huge` runs only when the expression selects it because of
that mark; without `-m` it skips (tests/conftest.py)."""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# both conftest files are module `conftest`; the tests' own holds that name
_spec = importlib.util.spec_from_file_location(
    "repo_conftest", os.path.join(REPO, "conftest.py"))
repo_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(repo_conftest)


@pytest.mark.parametrize("markexpr,names,skipped", [
    ("not slow", {"huge"}, True),
    ("huge", {"huge"}, False),
    ("huge or slow", {"huge"}, False),
    ("huge or not slow", {"huge"}, True),
    ("slow", {"huge", "slow"}, True),
    ("huge and slow", {"huge", "slow"}, False),
], ids=["not_slow", "huge_alone", "huge_or_slow", "huge_or_not_slow",
        "slow_on_both", "huge_and_slow_on_both"])
def test_huge_skipped(markexpr, names, skipped):
    assert repo_conftest.huge_skipped(markexpr, names) is skipped


@pytest.mark.parametrize("markexpr", ["not slow", None],
                         ids=["not_slow", "none"])
def test_huge_test_skips_at_once(markexpr):
    """The suite's own `-m 'not slow'`, and no `-m`, skip the GRCh38-scale
    test before its module fixture builds anything."""
    mark = ["-m", markexpr] if markexpr else []
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rs", "-p",
         "no:cacheprovider", *mark, "tests/test_genome_huge.py"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "1 skipped" in res.stdout, res.stdout[-2000:]
    assert "huge; run with -m huge" in res.stdout, res.stdout[-2000:]
