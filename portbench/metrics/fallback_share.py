"""Share of the window's reads that the seeder hands to the host engine
(DeviceAligner.stats["fallback_reads"])."""


def read(run):
    return 100.0 * run.program["fallback_reads"] / run.reads \
        if run.reads else None
