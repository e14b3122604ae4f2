"""Environment gates of the runtime services, read on every call.

The JAX package checks each subsystem's variable before it imports the
subsystem's module, so an unset variable keeps the module out of the
process.  The port keeps the same variables with the same meanings:

- ``DSQL_TENANCY`` (default on; ``0`` turns tenancy off) gates
  ``runtime/tenancy.py``, and ``DSQL_INGEST_DIR`` (unless ``DSQL_INGEST``
  is ``0``) arms ``runtime/ingest.py``; the port has both.
- ``DSQL_PROFILE`` arms ``runtime/profiler.py``, ``DSQL_HISTORY_FILE``
  ``runtime/flight_recorder.py`` and ``DSQL_EVENTS`` ``runtime/events.py``;
  ``DSQL_FLEET_DIR`` arms ``runtime/fleet.py`` and ``DSQL_AUTOPILOT``
  ``runtime/autopilot.py``.  The port has all five, and every caller
  checks the variable before it imports the module, so an unarmed query
  loads none of them.
- The subsystem of ``UNPORTED`` (the program store) is armed only by its
  variable, and its module is not ported.  Unset, the port behaves as the
  JAX package does with it unset.  Set, ``refuse`` raises
  ``NotImplementedError`` naming the module, at the places where the JAX
  package would import it: the port never silently answers without a
  subsystem its caller armed.
"""
from __future__ import annotations

import os

#: variable -> the JAX package's module it arms (not ported)
UNPORTED = {
    "DSQL_PROGRAM_STORE": "runtime/program_store.py",
}


def _flag(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default).strip() not in ("", "0")


def tenancy_on() -> bool:
    return _flag("DSQL_TENANCY", "1")


def profile_on() -> bool:
    """``DSQL_PROFILE`` arms the device profiler (``runtime/profiler.py``)."""
    return _flag("DSQL_PROFILE")


def history_on() -> bool:
    """``DSQL_HISTORY_FILE`` arms the flight recorder
    (``runtime/flight_recorder.py``)."""
    return bool(os.environ.get("DSQL_HISTORY_FILE"))


def events_on() -> bool:
    """``DSQL_EVENTS`` arms the event bus (``runtime/events.py``)."""
    return _flag("DSQL_EVENTS")


def armed(variable: str) -> bool:
    """Whether ``variable`` arms its subsystem, by the JAX package's rule
    for it: a path variable arms when set (ingest unless ``DSQL_INGEST``
    is ``0``/``false``), a switch when neither empty nor ``0``."""
    if variable in ("DSQL_FLEET_DIR", "DSQL_HISTORY_FILE",
                    "DSQL_PROGRAM_STORE"):
        return bool(os.environ.get(variable))
    if variable == "DSQL_INGEST_DIR":
        return bool(os.environ.get(variable)) and os.environ.get(
            "DSQL_INGEST", "1").strip() not in ("0", "false")
    return _flag(variable)


def refuse(*variables: str) -> None:
    """Raise ``NotImplementedError`` for the first of ``variables`` (all
    of ``UNPORTED`` when none are named) that is armed."""
    for variable in variables or tuple(UNPORTED):
        if armed(variable):
            raise NotImplementedError(
                f"{variable} arms {UNPORTED[variable]}, which is not ported "
                f"yet; unset it to run without that subsystem")
