"""Scheduler plane, admission side: tenant policies and token buckets,
the port's own copy of ``move2kube_tpu/serving/sched/admission.py``.

One spec string configures the whole plane so the router and the engine
can parse it independently (the tenant already rides every Request; the
priority need not ride the replica wire format too):

    M2KT_SCHED_TENANTS="gold:prio=high,rate=50,burst=100;free:prio=besteffort"

``prio`` is one of ``high | standard | besteffort`` (a higher class may
preempt a lower one under pressure, see the engine's ``_admit_one``).
``rate`` is the token-bucket refill in requests/s and ``burst`` the
bucket depth; 0 (or absent) means unlimited. The same information may
come split across two simpler knobs:

    M2KT_SCHED_PRIORITIES="gold:high;free:besteffort"
    M2KT_SCHED_QUOTAS="gold:50/100;free:5/10"        # rate/burst

Both forms merge (the combined spec wins per field). Parsing is
tolerant: a malformed entry warns and is skipped, never raises, so a
typo in a deployment value does not take the router down.
"""

from __future__ import annotations

import dataclasses
import threading
import time

# priority classes, higher may preempt lower. Keys are what the spec
# says; values order the scheduler.
PRIORITIES = {"high": 2, "standard": 1, "besteffort": 0}
DEFAULT_PRIORITY = "standard"


class SchedThrottled(ValueError):
    """Raised at admission when a tenant is over its token-bucket quota.

    A ValueError so existing submit-time rejection paths treat it as a
    client error; the router HTTP front maps it to 429."""


@dataclasses.dataclass
class TenantPolicy:
    """One tenant's scheduling contract."""

    name: str
    priority: str = DEFAULT_PRIORITY
    rate: float = 0.0   # requests/s refill; 0 = unlimited
    burst: float = 0.0  # bucket depth; 0 = unlimited

    @property
    def priority_class(self) -> int:
        return PRIORITIES.get(self.priority, PRIORITIES[DEFAULT_PRIORITY])


def _warn(msg: str) -> None:
    print(f"[m2kt] WARNING: {msg}", flush=True)


def parse_tenant_spec(spec: str, *, warn=_warn) -> dict:
    """``"gold:prio=high,rate=50,burst=100;free:prio=besteffort"`` →
    {tenant: TenantPolicy}. Malformed entries warn and are skipped."""
    policies: dict[str, TenantPolicy] = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, body = entry.partition(":")
        name = name.strip()
        if not name:
            warn(f"sched tenant entry {entry!r} has no tenant name; skipped")
            continue
        pol = policies.get(name) or TenantPolicy(name)
        ok = True
        for field in body.split(","):
            field = field.strip()
            if not field:
                continue
            key, _, val = field.partition("=")
            key, val = key.strip(), val.strip()
            if key == "prio":
                if val not in PRIORITIES:
                    warn(f"sched tenant {name!r}: unknown priority {val!r} "
                         f"(want one of {sorted(PRIORITIES)}); skipped")
                    ok = False
                    break
                pol.priority = val
            elif key in ("rate", "burst"):
                try:
                    num = float(val)
                except ValueError:
                    num = -1.0
                if num < 0:
                    warn(f"sched tenant {name!r}: bad {key} {val!r}; skipped")
                    ok = False
                    break
                setattr(pol, key, num)
            else:
                warn(f"sched tenant {name!r}: unknown field {key!r}; skipped")
                ok = False
                break
        if ok:
            policies[name] = pol
    return policies


def merge_split_specs(policies: dict, priorities: str = "",
                      quotas: str = "", *, warn=_warn) -> dict:
    """Layer the split knobs under an (optionally empty) combined
    spec: ``priorities`` is ``"gold:high;free:besteffort"``, ``quotas``
    is ``"gold:50/100"`` (rate/burst). The combined spec wins."""
    out = {n: dataclasses.replace(p) for n, p in policies.items()}

    def _base(name: str) -> TenantPolicy:
        return out.setdefault(name, TenantPolicy(name))

    for entry in (priorities or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, prio = entry.partition(":")
        name, prio = name.strip(), prio.strip()
        if not name or prio not in PRIORITIES:
            warn(f"sched priority entry {entry!r} malformed "
                 f"(want tenant:{'|'.join(sorted(PRIORITIES))}); skipped")
            continue
        pol = _base(name)
        if name not in policies:
            pol.priority = prio
    for entry in (quotas or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, q = entry.partition(":")
        rate_s, _, burst_s = q.partition("/")
        try:
            rate, burst = float(rate_s), float(burst_s)
            if rate < 0 or burst < 0:
                raise ValueError(q)
        except ValueError:
            warn(f"sched quota entry {entry!r} malformed "
                 "(want tenant:rate/burst); skipped")
            continue
        name = name.strip()
        if not name:
            warn(f"sched quota entry {entry!r} has no tenant name; skipped")
            continue
        pol = _base(name)
        if name not in policies:
            pol.rate, pol.burst = rate, burst
    return out


class TokenBucket:
    """Classic token bucket with an injectable monotonic clock (tests
    drive refill deterministically, like SLOTracker)."""

    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill()
            return self._tokens

    def _refill(self) -> None:
        now = self._clock()
        dt = max(0.0, now - self._last)
        self._last = now
        self._tokens = min(self.burst, self._tokens + dt * self.rate)

    def take(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill()
            if self._tokens + 1e-9 >= n:
                self._tokens -= n
                return True
            return False


class AdmissionController:
    """Per-tenant token-bucket quotas + priority lookup.

    Lives at the router front (throttling before placement) and, for
    priority only, inside the engine (preemption ordering). Unknown
    tenants get the default policy: standard priority, unlimited."""

    def __init__(self, policies: dict, registry=None,
                 clock=time.monotonic) -> None:
        self.policies = dict(policies or {})
        self._clock = clock
        self._buckets: dict[str, TokenBucket] = {}
        for name, pol in self.policies.items():
            if pol.rate > 0 and pol.burst > 0:
                self._buckets[name] = TokenBucket(pol.rate, pol.burst,
                                                  clock=clock)
        self._throttled = None
        if registry is not None:
            self._throttled = registry.counter(
                "m2kt_sched_throttled_total",
                "Requests refused at admission by the scheduler",
                labels=("reason",))

    @classmethod
    def from_specs(cls, tenants: str = "", priorities: str = "",
                   quotas: str = "", registry=None,
                   clock=time.monotonic, warn=_warn) -> "AdmissionController":
        policies = merge_split_specs(parse_tenant_spec(tenants, warn=warn),
                                     priorities, quotas, warn=warn)
        return cls(policies, registry=registry, clock=clock)

    @property
    def configured(self) -> bool:
        return bool(self.policies)

    def policy(self, tenant: str) -> TenantPolicy:
        pol = self.policies.get(tenant or "")
        return pol if pol is not None else TenantPolicy(tenant or "")

    def priority(self, tenant: str) -> int:
        return self.policy(tenant).priority_class

    def distinct_priorities(self) -> bool:
        """Preemption only makes sense when the policies actually rank
        tenants differently; with a flat (or empty) spec the engine
        keeps its historical never-preempt behavior."""
        classes = {p.priority_class for p in self.policies.values()}
        classes.add(PRIORITIES[DEFAULT_PRIORITY])
        return len(classes) > 1

    def admit(self, tenant: str) -> None:
        """Raise SchedThrottled when the tenant is over quota."""
        bucket = self._buckets.get(tenant or "")
        if bucket is not None and not bucket.take():
            if self._throttled is not None:
                self._throttled.labels(reason="quota").inc()
            raise SchedThrottled(
                f"tenant {tenant!r} over quota "
                f"({bucket.rate:g} req/s, burst {bucket.burst:g})")
