"""Queries answered in the window over the window's seconds (host clock)."""


def read(run):
    if not run.window or run.window_s <= 0:
        return None
    return len(run.window) / run.window_s
