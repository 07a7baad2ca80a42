"""Own device time of the program's hand-written kernels (csrc/*.cu) in
the traced window, milliseconds a million reads (torch.profiler)."""


def read(run):
    t = run.trace
    if not t or not t["port_kernel_s"] or not run.reads:
        return None
    return t["port_kernel_s"] * 1e3 / (run.reads / 1e6)
