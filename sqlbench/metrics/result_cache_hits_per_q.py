"""Result-cache hits over the window's queries: whole answers and stage
outputs the port's result cache served (each report's cache verdict and
its subplan hits)."""


def read(run):
    if not run.window:
        return None
    return sum(q.facts.get("cache_hits", 0) for q in run.window) \
        / len(run.window)
