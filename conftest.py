"""Repo-wide pytest hook: a test marked `huge` runs only when `-m` asks
for it by that mark.

Without `-m`, tests/conftest.py skips `huge` and `slow` tests. Under an
`-m` expression it leaves the choice to the expression, which let
`-m 'not slow'` start the GRCh38-scale build of tests/test_genome_huge.py.
Here a `huge` test that the expression selects is skipped if the
expression would select it without the mark too: `-m huge` and
`-m 'huge or slow'` run it, `-m 'not slow'` and `-m 'huge or not slow'`
skip it.
"""

import pytest
from _pytest.mark.expression import Expression


def huge_skipped(markexpr, names):
    """Whether a `huge` test, its marks named `names`, that `-m markexpr`
    selects is skipped: when the expression is also true for its marks
    without `huge`."""
    rest = names - {"huge"}
    return Expression.compile(markexpr).evaluate(
        lambda name, **kwargs: name in rest)


def pytest_collection_modifyitems(config, items):
    markexpr = config.getoption("-m", default="")
    if not markexpr:
        return
    skip = pytest.mark.skip(reason="huge; run with -m huge")
    for item in items:
        names = {m.name for m in item.iter_markers()}
        if "huge" in names and huge_skipped(markexpr, names):
            item.add_marker(skip)
