"""1 - the union of device activity over the traced window, in percent
(torch.profiler; the window's ends marked on the device)."""


def read(run):
    t = run.trace
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
