"""Single reads (simulate.simulate_reads) in one FASTQ file, named
r<read>. ``cli mem`` plans one file as single-end: a chunk closes at the
read whose bases take it past -K, and each chunk is aligned with
n_processed the reads before it (mainParallel.c:2773, :2355-2357).

Traffic keys: read_len, or length (dist lognormal, mean, sd, min, max);
the errors, either sub_rate, indel_rate and indel_extend (wgsim) or
accuracy (mean, sd, min) and error_ratio (sub, ins, del; PBSIM);
sample_reads sizes the check's sample.
"""

import os

import numpy as np

from harness import simulate as S

PAIRED = False
SAMPLE = "sample_reads"


def pool(codes, seed: int, traffic: dict, chunk_bases: int, n_chunks: int,
         directory: str) -> S.Pool:
    lengths = S.read_lengths(seed, traffic, chunk_bases, n_chunks)
    reads = S.simulate_reads(codes, lengths, seed, traffic)
    path = os.path.join(directory, "r1.fq")
    with open(path, "wb") as fh:
        fh.write(S.fastq_bytes(reads.seq, reads.offset, b"r"))
    units = S.chunk_counts(lengths, chunk_bases)
    first = np.concatenate([[0], np.cumsum(units)[:-1]])
    return S.Pool(reads, [path], first, units, 1,
                  [int(f) for f in first], S.read_name)
