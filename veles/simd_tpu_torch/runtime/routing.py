"""Routing engine, static half: candidate tables and selection.

The port's counterpart of ``veles.simd_tpu.runtime.routing``.  Each op
family declares a :func:`family` of :class:`Route` entries in priority
order; a route's predicate is the geometry gate where its constants
live, and ``disable_env`` names a truthy environment variable that
closes the gate.  Static selection is the first eligible route in table
order.

Not ported yet: the measured autotuner and its persistent tune cache
(``VELES_SIMD_AUTOTUNE``), and the fault-injection sites and rejection
caches of the JAX routes.  So :meth:`Family.select` is always the
static prior, the JAX engine's behaviour under autotune ``off``.
"""

from __future__ import annotations

import dataclasses
import os
import threading

__all__ = ["Route", "Family", "family", "get_family", "pow2_bucket",
           "env_truthy"]


def pow2_bucket(v: int) -> int:
    """Geometry-class bucketing: the next power of two >= ``v``."""
    v = int(v)
    if v <= 1:
        return v
    return 1 << (v - 1).bit_length()


def env_truthy(name: str) -> bool:
    """Is the escape-hatch env var ``name`` set truthy?"""
    return os.environ.get(name, "0").strip().lower() in (
        "1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class Route:
    """One candidate in a family's table.

    ``predicate(**geom) -> bool`` is the geometry gate (None =
    unconditionally eligible, the table's terminal fallback);
    ``disable_env`` names a truthy env var that closes the gate;
    ``doc`` is one line for humans.
    """

    name: str
    predicate: object = None
    disable_env: str | None = None
    doc: str = ""

    def gate(self, geom: dict) -> bool:
        """Env opt-out, then the predicate."""
        if self.disable_env and env_truthy(self.disable_env):
            return False
        if self.predicate is None:
            return True
        return bool(self.predicate(**geom))


class Family:
    """One op family's candidate table; routes in PRIORITY order."""

    def __init__(self, name: str, routes):
        self.name = str(name)
        self._routes: dict[str, Route] = {}
        for r in routes:
            if r.name in self._routes:
                raise ValueError(f"duplicate route {r.name!r} in "
                                 f"family {name!r}")
            self._routes[r.name] = r
        if not self._routes:
            raise ValueError(f"family {name!r} has no routes")

    def names(self) -> tuple:
        return tuple(self._routes)

    def route(self, name: str) -> Route:
        try:
            return self._routes[name]
        except KeyError:
            raise ValueError(
                f"route must be one of {sorted(self._routes)}, "
                f"got {name!r}") from None

    def gate(self, name: str, **geom) -> bool:
        """Pure geometry gate of one route (env + predicate)."""
        return self.route(name).gate(geom)

    def eligible(self, **geom) -> list:
        """Eligible route names in table order.  Never empty: when
        every gate refuses, the last route — the terminal fallback —
        is returned alone."""
        names = [n for n, r in self._routes.items() if r.gate(geom)]
        return names or [tuple(self._routes)[-1]]

    def static_select(self, **geom) -> str:
        """First eligible route in table order."""
        return self.eligible(**geom)[0]

    def select(self, eligible=None, **geom) -> str:
        """Pick the route to dispatch: the first of ``eligible`` (a
        priority-ordered list the caller computed, so dispatch and its
        gates never disagree), or of the table's own eligibility when
        None."""
        if eligible is None:
            eligible = self.eligible(**geom)
        if not eligible:
            eligible = [tuple(self._routes)[-1]]
        return eligible[0]


_families_lock = threading.Lock()
_FAMILIES: dict[str, Family] = {}


def family(name: str, routes) -> Family:
    """Declare (and register) one op family's candidate-route table.
    Re-declaring a name replaces the registration."""
    fam = Family(name, routes)
    with _families_lock:
        _FAMILIES[fam.name] = fam
    return fam


def get_family(name: str) -> Family:
    with _families_lock:
        try:
            return _FAMILIES[name]
        except KeyError:
            raise ValueError(
                f"unknown route family {name!r} "
                f"(registered: {sorted(_FAMILIES)})") from None
