"""DeviceSeeder.times fwd1 + bwd1 + pass2 + pass3 + sortout a million
reads, summed over workers."""


def read(run):
    return run.program["seed_s"] / (run.reads / 1e6) if run.reads else None
