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
- ``DSQL_PROGRAM_STORE`` arms ``runtime/program_store.py``, which holds
  build records where the JAX package holds executables.

Every subsystem of the JAX package that a variable arms is ported.
"""
from __future__ import annotations

import os


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
