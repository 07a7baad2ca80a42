"""DeviceAligner.stats["t"]["emit"] (the C finalize to SAM text) a million
reads, summed over workers."""


def read(run):
    return run.program["emit_s"] / (run.reads / 1e6) if run.reads else None
