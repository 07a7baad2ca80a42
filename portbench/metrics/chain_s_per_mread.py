"""DeviceAligner.stats["t"]["chain"] (the C chain session) a million
reads, summed over workers."""


def read(run):
    return run.program["chain_s"] / (run.reads / 1e6) if run.reads else None
