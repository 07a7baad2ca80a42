"""Device time of everything that is not one of the program's kernels
(PyTorch's kernels, copies, fills) in the traced window, milliseconds a
million reads (torch.profiler)."""


def read(run):
    t = run.trace
    if not t or not t["other_s"] or not run.reads:
        return None
    return t["other_s"] * 1e3 / (run.reads / 1e6)
