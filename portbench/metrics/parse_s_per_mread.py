"""Seconds of FASTQ parsing (ChunkPlan.get_batch, the span that
Runtime.times["parse"] sums) a million reads, summed over workers."""


def read(run):
    return run.parse_s / (run.reads / 1e6) if run.reads else None
