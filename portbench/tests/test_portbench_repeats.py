"""The repeat statistics' k-mer counts against a count by hand."""

import numpy as np
import torch

import repeat_stats as R


def test_occurrences_count_both_strands_and_skip_n():
    rng = np.random.default_rng(4)
    g = rng.integers(0, 4, 3000).astype(np.int64)
    g[1000:1040] = 3 - g[200:240][::-1]  # a reverse-complement copy
    g[2500] = 4
    k = 7
    fwd, ok = R.kmers(torch.from_numpy(g), k)
    table = torch.sort(fwd[ok]).values
    occ, _ = R.both_strands(table, torch.from_numpy(g), k)
    text = ["".join(map(str, g[i: i + k])) for i in range(len(g) - k + 1)]
    for i in (0, 205, 1010, 2495, 2600):
        if 4 in g[i: i + k]:
            assert not bool(ok[i])
            continue
        rc = "".join(str(3 - c) for c in g[i: i + k][::-1])
        assert int(occ[i]) == text.count(text[i]) + text.count(rc)
    assert int(occ[205]) >= 2  # the copy on the other strand
