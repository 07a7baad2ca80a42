"""Paired reads of one length (simulate.simulate_pairs) in two equal-size
FASTQ files, R1 and R2, named p<pair>. ``cli mem`` plans such files as
untrimmed pairs: a chunk closes once both mates' bases pass half of -K,
and each chunk is aligned with n_processed 0 (mainParallel.c:947, :1314).

Traffic keys: read_len, insert_mean, insert_sd, insert_min, insert_max,
sub_rate, indel_rate, indel_extend; sample_pairs sizes the check's
sample.
"""

import os

import numpy as np

from harness import simulate as S

PAIRED = True
SAMPLE = "sample_pairs"


def pool(codes, seed: int, traffic: dict, chunk_bases: int, n_chunks: int,
         directory: str) -> S.Pool:
    per = S.pairs_per_chunk(chunk_bases, int(traffic["read_len"]))
    pairs = S.simulate_pairs(codes, n_chunks * per, seed, traffic)
    paths = [os.path.join(directory, f"r{m}.fq") for m in (1, 2)]
    for path, reads in zip(paths, (pairs.r1, pairs.r2)):
        offset = np.arange(len(reads) + 1, dtype=np.int64) * reads.shape[1]
        with open(path, "wb") as fh:
            fh.write(S.fastq_bytes(reads.ravel(), offset))
    return S.Pool(pairs, paths, np.arange(n_chunks) * per,
                  np.full(n_chunks, per), 2, [0] * n_chunks, S.pair_name)
