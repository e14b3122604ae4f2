"""The share of the window's queries answered by graph replays alone: the
compiled tier answered (span attribute ``tier``), the query's own spans
show a replay and no build (no ``compile`` span, no capture), and the
result cache did not answer."""


def read(run):
    if not run.window:
        return None
    replayed = sum(1 for q in run.window
                   if q.facts.get("tier") == "compiled"
                   and q.facts.get("replayed") and not q.facts.get("built")
                   and not q.facts.get("cache_hit"))
    return 100.0 * replayed / len(run.window)
