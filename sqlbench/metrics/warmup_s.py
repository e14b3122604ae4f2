"""Host seconds of the warm-up: each template once per pass, the port's
background builds waited for (store hits, captures, compiles)."""


def read(run):
    return run.setup.get("warmup_s")
