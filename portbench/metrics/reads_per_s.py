"""Reads (each mate counts) whose SAM record came out, over the window:
the first chunk handed in to the last record out (host clock)."""


def read(run):
    return run.reads / run.window_s
