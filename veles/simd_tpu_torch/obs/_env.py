"""A cheap ``os.environ.get`` for knobs read on every call.

On POSIX ``os.environ`` keeps its values in a dict of bytes that every
write through ``os.environ`` updates; a lookup there skips the two
exceptions ``Mapping.get`` raises and catches for an unset name (about
1 us a read).  A healthy guarded call reads the fault plan, the
watchdog knob and each armed route gate's plan, and every decision
event asks whether the journal is armed.  A leaf module, so that
``obs`` and ``runtime`` can both import it.
"""

from __future__ import annotations

import os

_ENVIRON_DATA = getattr(os.environ, "_data", None) \
    if os.name == "posix" else None
if not isinstance(_ENVIRON_DATA, dict):
    _ENVIRON_DATA = None


def getenv(name: str) -> str | None:
    """``os.environ.get(name)``, at a dict lookup's cost on POSIX."""
    if _ENVIRON_DATA is None:
        return os.environ.get(name)
    raw = _ENVIRON_DATA.get(name.encode())
    return None if raw is None else os.fsdecode(raw)
