"""Host seconds of the ``create_table`` calls (encoding, statistics,
placement) until the card is idle."""


def read(run):
    return run.setup.get("load_s")
