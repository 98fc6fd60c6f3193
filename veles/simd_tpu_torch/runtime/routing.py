"""Routing engine, static half: candidate tables and selection.

The port's counterpart of ``veles.simd_tpu.runtime.routing``.  Each op
family declares a :func:`family` of :class:`Route` entries in priority
order; a route's predicate is the geometry gate where its constants
live, ``disable_env`` names a truthy environment variable that closes
the gate, ``fault_site`` is the injection-plan site whose armed state
opens it (:func:`veles.simd_tpu_torch.runtime.faults.armed`), and
``rejection_cache`` / ``rejection_key`` are the demote-and-remember
memory that closes it for a geometry the card refused.  Eligibility
follows the JAX engine's order of precedence: rejection memory first,
then an armed plan, then the env opt-out, then the predicate; static
selection is the first eligible route in table order.

:data:`SITE_NAMES` maps the JAX package's kernel-route fault sites to
the port's (``pallas`` → ``cuda``, as the route names map), so a JAX
chaos plan runs here through :func:`port_plan`.

Not ported yet: the measured autotuner and its persistent tune cache
(``VELES_SIMD_AUTOTUNE``).  So :meth:`Family.select` is always the
static prior, the JAX engine's behaviour under autotune ``off``.
"""

from __future__ import annotations

import dataclasses
import threading

from veles.simd_tpu_torch.runtime import faults

__all__ = ["Route", "Family", "family", "families", "get_family",
           "pow2_bucket", "env_truthy", "SITE_NAMES", "port_plan"]

# JAX package fault site -> the port's site for the same route; the
# dispatch sites (convolve.dispatch, stft.dispatch, istft.dispatch,
# convolve2d.dispatch, segments.dispatch, segments.segment) keep their
# names
SITE_NAMES = {"convolve.os_pallas": "convolve.os_cuda",
              "convolve2d.direct_pallas": "convolve2d.direct_cuda",
              "spectral.stft_pallas": "spectral.stft_cuda"}


def port_plan(spec: str) -> str:
    """A JAX package fault plan (``site[@subsite]:kind[:count],...``,
    or a phase schedule of them) with its sites renamed by
    :data:`SITE_NAMES`."""
    def entry(e):
        site, sep, rest = e.strip().partition(":")
        base, at, sub = site.partition("@")
        return SITE_NAMES.get(base, base) + at + sub + sep + rest

    def body(b):
        return ",".join(entry(e) for e in b.split(",") if e.strip())

    phases = []
    for part in spec.split(";"):
        label, eq, rest = part.rpartition("=")
        phases.append(label + eq + body(rest))
    return ";".join(phases)


def pow2_bucket(v: int) -> int:
    """Geometry-class bucketing: the next power of two >= ``v``."""
    v = int(v)
    if v <= 1:
        return v
    return 1 << (v - 1).bit_length()


def env_truthy(name: str) -> bool:
    """Is the escape-hatch env var ``name`` set truthy?"""
    return (faults.getenv(name) or "0").strip().lower() in (
        "1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class Route:
    """One candidate in a family's table.

    ``predicate(**geom) -> bool`` is the geometry gate (None =
    unconditionally eligible, the table's terminal fallback);
    ``disable_env`` names a truthy env var that closes the gate;
    ``fault_site`` is the injection-plan site whose armed state opens
    it, so the CPU really selects the doomed route;
    ``rejection_cache`` is a ZERO-ARG GETTER returning the bounded
    rejection set the demote-and-remember policy feeds (tests
    substitute plain sets through the owning module's global) and
    ``rejection_key(**geom)`` derives the remembered key; ``doc`` is
    one line for humans.
    """

    name: str
    predicate: object = None
    disable_env: str | None = None
    fault_site: str | None = None
    rejection_cache: object = None
    rejection_key: object = None
    doc: str = ""

    def rejected(self, geom: dict) -> bool:
        if self.rejection_cache is None or self.rejection_key is None:
            return False
        try:
            return self.rejection_key(**geom) in self.rejection_cache()
        except Exception:  # noqa: BLE001 — a bad key never blocks
            return False

    def gate(self, geom: dict) -> bool:
        """Env opt-out, then the predicate (no rejection memory, no
        armed plan): the pure geometry gate."""
        if self.disable_env and env_truthy(self.disable_env):
            return False
        if self.predicate is None:
            return True
        return bool(self.predicate(**geom))

    def allowed(self, geom: dict) -> bool:
        """Full eligibility: rejection memory outranks everything (a
        demoted geometry skips the route without re-raising), an armed
        fault plan opens the gate, then env + predicate."""
        if self.rejected(geom):
            return False
        if self.fault_site and faults.armed(self.fault_site):
            return True
        return self.gate(geom)


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

    def describe(self) -> dict:
        """JSON-native table summary (tools, docs, tests)."""
        return {"family": self.name,
                "routes": [{"name": r.name,
                            "disable_env": r.disable_env,
                            "fault_site": r.fault_site,
                            "has_rejection_cache":
                                r.rejection_cache is not None,
                            "doc": r.doc}
                           for r in self._routes.values()]}

    def gate(self, name: str, **geom) -> bool:
        """Pure geometry gate of one route (env + predicate)."""
        return self.route(name).gate(geom)

    def route_allowed(self, name: str, **geom) -> bool:
        """Full eligibility of one route (rejection memory, armed
        fault plan, env, predicate)."""
        return self.route(name).allowed(geom)

    def eligible(self, **geom) -> list:
        """Eligible route names in table order, by full eligibility.
        Never empty: when every route refuses, the last route — the
        terminal fallback — is returned alone."""
        names = [n for n, r in self._routes.items() if r.allowed(geom)]
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


def families() -> dict:
    """Name -> :class:`Family` snapshot of every registered table."""
    with _families_lock:
        return dict(_FAMILIES)


def get_family(name: str) -> Family:
    with _families_lock:
        try:
            return _FAMILIES[name]
        except KeyError:
            raise ValueError(
                f"unknown route family {name!r} "
                f"(registered: {sorted(_FAMILIES)})") from None
