"""Process start to the first chunk of the window: genome, index load and
upload, FASTQ pool, workers, one warm-up chunk a worker (host clock)."""


def read(run):
    return run.setup_s
