"""Reads (each mate counts) whose SAM record came out, over the window:
the first chunk handed in to the last record out (host clock). The
end-to-end reads_per_s where it is not one: its runs spread wider than
a bound may hold."""


def read(run):
    return run.reads / run.window_s
