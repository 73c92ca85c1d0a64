"""Deterministic fault injection — counterpart of
``sparkdl_tpu/resilience/faults.py``, for the sites the port threads
through its hot paths:

============================  ================================================
site                          where it fires
============================  ================================================
``engine.source_load``        ``LocalEngine`` partition source load
``engine.stage_apply``        every engine stage call (pooled + stream paths)
``ship.device_put``           per-chunk input placement in ``dispatch_chunks``
``ship.drain``                per-batch result drain (``drain_bounded``)
``pipeline.worker_decode``    a pooled partition's decode, in the worker
``pipeline.worker_death``     a pooled worker process exits on the spot
``inputsvc.rpc``              each decode-fleet fragment RPC (client side)
``snapshot.read``             each warm snapshot-chunk read
============================  ================================================

Sites that fire inside a pool worker process arm there only from
``SPARKDL_TPU_FAULTS`` (a spawned worker reads the env at import; a
programmatic :func:`inject` stays in the process that called it).

Each armed site draws from its own seeded RNG and raises a typed fault
at the configured rate.

Arming:

* ``SPARKDL_TPU_FAULTS=<site>:<kind>:<rate>[:seed]`` (comma-separate
  several sites), parsed once at import — kinds are ``transient``
  (raises :class:`InjectedFault`, the retryable drill) and
  ``permanent`` (raises :class:`InjectedPermanentFault`, the fail-fast
  drill); ``rate`` is the per-call injection probability in (0, 1];
  ``seed`` defaults to 0. A malformed env spec degrades to disarmed
  with one warning — a typo must not take down a process.
* programmatic :func:`inject` / :func:`disarm` for tests and drills
  (bad arguments raise :class:`FaultSpecError`).

Each site counts its checks and injections; :func:`state` renders the
armed config and those counts. Disarmed, :func:`maybe_fail` is one
module-global read and a ``None`` check.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from typing import Dict, Optional

from sparkdl_tpu_torch.resilience.errors import PermanentError, TransientError

logger = logging.getLogger(__name__)

#: every site threaded through the port (module table above) — the
#: harness refuses unknown names so a drill config typo cannot arm a
#: site that nothing ever checks
SITES = (
    "engine.source_load",
    "engine.stage_apply",
    "ship.device_put",
    "ship.drain",
    "pipeline.worker_decode",
    "pipeline.worker_death",
    "inputsvc.rpc",
    "snapshot.read",
)

_KINDS = ("transient", "permanent")


class FaultSpecError(ValueError):
    """A programmatic :func:`inject` call named an unknown site/kind or
    an out-of-range rate."""


class InjectedFault(TransientError):
    """A transient injected fault — classified retryable."""


class InjectedPermanentFault(PermanentError):
    """A permanent injected fault — classified non-retryable."""


class _SiteFault:
    """One armed site: its kind, rate, and a private seeded RNG."""

    def __init__(self, site: str, kind: str, rate: float, seed: int):
        self.site = site
        self.kind = kind
        self.rate = float(rate)
        self.seed = int(seed)
        self.checks = 0
        self.injected = 0
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    def check(self) -> None:
        with self._lock:
            self.checks += 1
            fire = self._rng.random() < self.rate
            if fire:
                self.injected += 1
        if not fire:
            return
        if self.kind == "permanent":
            raise InjectedPermanentFault(
                f"injected permanent fault at {self.site} "
                f"(rate={self.rate}, seed={self.seed})")
        raise InjectedFault(
            f"injected transient fault at {self.site} "
            f"(rate={self.rate}, seed={self.seed})")

    def state(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "rate": self.rate,
                    "seed": self.seed, "checks": self.checks,
                    "injected": self.injected}


#: the armed plan: ``None`` = disarmed. Replaced wholesale on every
#: (re)arm, so readers never see a half-built plan.
_PLAN: Optional[Dict[str, _SiteFault]] = None
_SPEC: str = ""


def maybe_fail(site: str) -> None:
    """The per-site hook the hot paths call: disarmed, one global read;
    armed, one seeded draw, raising the typed fault at the configured
    rate."""
    plan = _PLAN
    if plan is None:
        return
    sf = plan.get(site)
    if sf is not None:
        sf.check()


def _spec_of(plan: Dict[str, _SiteFault]) -> str:
    return ",".join(f"{s}:{f.kind}:{f.rate}:{f.seed}"
                    for s, f in sorted(plan.items()))


def inject(site: str, kind: str = "transient", rate: float = 1.0,
           seed: int = 0) -> None:
    """Programmatically arm one site; repeated calls add/replace sites
    without touching others. Loud on bad arguments."""
    if site not in SITES:
        raise FaultSpecError(
            f"unknown fault site {site!r}; sites: {', '.join(SITES)}")
    if kind not in _KINDS:
        raise FaultSpecError(
            f"unknown fault kind {kind!r}; kinds: {', '.join(_KINDS)}")
    if not 0.0 < float(rate) <= 1.0:
        raise FaultSpecError(f"rate must be in (0, 1], got {rate}")
    global _PLAN, _SPEC
    plan = dict(_PLAN or {})
    plan[site] = _SiteFault(site, kind, float(rate), int(seed))
    _SPEC = _spec_of(plan)
    _PLAN = plan


def disarm(site: Optional[str] = None) -> None:
    """Disarm one site, or (no argument) the whole harness."""
    global _PLAN, _SPEC
    if site is None or _PLAN is None:
        _PLAN = None
        _SPEC = ""
        return
    plan = {s: f for s, f in _PLAN.items() if s != site}
    _PLAN = plan or None
    _SPEC = _spec_of(plan)


def armed() -> bool:
    return _PLAN is not None


def spec() -> str:
    """The armed spec string (``""`` disarmed)."""
    return _SPEC


def state() -> dict:
    """Armed-ness, the effective spec, and per-site config + counts."""
    plan = _PLAN
    return {
        "armed": plan is not None,
        "spec": _SPEC,
        "sites": {s: f.state() for s, f in sorted((plan or {}).items())},
    }


def _parse_env(raw: str) -> Optional[Dict[str, _SiteFault]]:
    """``site:kind:rate[:seed]`` comma list → plan; None on any
    malformed entry."""
    plan: Dict[str, _SiteFault] = {}
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (3, 4):
            return None
        site, kind, rate = parts[0].strip(), parts[1].strip(), parts[2]
        seed = parts[3] if len(parts) == 4 else "0"
        if site not in SITES or kind not in _KINDS:
            return None
        try:
            rate_f = float(rate)
            seed_i = int(seed)
        except ValueError:
            return None
        if not 0.0 < rate_f <= 1.0:
            return None
        plan[site] = _SiteFault(site, kind, rate_f, seed_i)
    return plan or None


def arm_spec(raw: str) -> bool:
    """Arm from an explicit spec string — the env grammar; a malformed
    spec keeps the current plan with one warning."""
    global _PLAN, _SPEC
    raw = (raw or "").strip()
    if not raw:
        return _PLAN is not None
    plan = _parse_env(raw)
    if plan is None:
        logger.warning(
            "%r is not a valid fault spec "
            "(<site>:<kind>:<rate>[:seed], comma-separated; sites: %s; "
            "kinds: %s); fault injection stays disarmed",
            raw, ", ".join(SITES), ", ".join(_KINDS))
        return _PLAN is not None
    _PLAN = plan
    _SPEC = raw
    return True


def arm_from_env() -> bool:
    """Apply ``SPARKDL_TPU_FAULTS`` (idempotent; also runs at import)."""
    return arm_spec(os.environ.get("SPARKDL_TPU_FAULTS", ""))


arm_from_env()
