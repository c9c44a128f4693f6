"""The port's supervise.py against the JAX package's: health, supervision
and the version constants.

Both Supervisors run one scripted scenario each, driven by the same
injected clock, the same seeded jitter and the same failure script; the
registries' snapshots (the `health` RPC verb's schema) and the sleeps
they asked for must be equal. No arithmetic beyond the clock's sums
separates them, so the comparisons are exact."""

from __future__ import annotations

import random

import pytest

from dynolog_tpu import failpoints as jax_failpoints
from dynolog_tpu import supervise as jax_supervise
from dynolog_tpu_torch import failpoints as torch_failpoints
from dynolog_tpu_torch import supervise as torch_supervise

PACKAGES = ((jax_supervise, jax_failpoints),
            (torch_supervise, torch_failpoints))


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def now(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


def _restart(S, fp, sup, registry, sleeps):
    ticks = [0]

    def make_ticker():
        def tick():
            ticks[0] += 1
            if ticks[0] <= 2:
                raise RuntimeError(f"boom {ticks[0]}")
        return tick

    return "victim", make_ticker


def _backoff(S, fp, sup, registry, sleeps):
    fails = [0]

    def make_ticker():
        def tick():
            fails[0] += 1
            if fails[0] >= 6:
                sup.request_stop()
            raise RuntimeError("down")
        return tick

    return "flappy", make_ticker


def _park_and_probe(S, fp, sup, registry, sleeps):
    def make_ticker():
        def tick():
            # Down until the breaker has parked it once; the probe after
            # the park recovers it.
            snap = registry.component("flaky").snapshot()
            if snap["state"] != S.STATE_DEGRADED and snap["restarts"] < 3:
                raise RuntimeError("still down")
            if len(sleeps) > 6:
                sup.request_stop()
        return tick

    return "flaky", make_ticker


def _transient_null_factory(S, fp, sup, registry, sleeps):
    phase = [0]

    def make_ticker():
        p = phase[0]
        phase[0] += 1
        if p in (1, 2):
            return None

        def tick():
            if p == 0:
                raise RuntimeError("backend died")
        return tick

    return "flappy_backend", make_ticker


def _failpoint(S, fp, sup, registry, sleeps):
    fp.disarm_all()
    fp.arm("py.collector.step", "throw*2")

    def make_ticker():
        def tick():
            fp.fire("py.collector.step")
        return tick

    return "drilled", make_ticker


SCENARIOS = {
    "restart": _restart,
    "backoff": _backoff,
    "park_and_probe": _park_and_probe,
    "transient_null_factory": _transient_null_factory,
    "failpoint": _failpoint,
}


def _drive(S, fp, scenario: str) -> dict:
    clock = FakeClock()
    registry = S.HealthRegistry(now=clock.now)
    sup = S.Supervisor(
        registry, sleep=clock.sleep, rng=random.Random(7),
        backoff_initial_s=0.01, backoff_max_s=0.04,
        max_consecutive_failures=3, degraded_retry_s=5.0)
    sleeps: list = []

    def recording_sleep(seconds):
        sleeps.append(seconds)
        if len(sleeps) >= 12:
            sup.request_stop()  # a lap bound: the fake sleep never blocks
        clock.sleep(seconds)

    sup._sleep = recording_sleep
    name, make_ticker = SCENARIOS[scenario](S, fp, sup, registry, sleeps)
    try:
        sup.run(name, 1.0, make_ticker)
    finally:
        fp.disarm_all()
    return {"snapshot": registry.snapshot(), "sleeps": sleeps,
            "all_up": registry.all_up()}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_supervisors_agree(scenario):
    jax_run, torch_run = (_drive(S, fp, scenario) for S, fp in PACKAGES)
    assert torch_run == jax_run
    assert torch_run["sleeps"], "the scenario never slept"


def test_null_factory_disables_alike():
    snaps = []
    for S, _ in PACKAGES:
        clock = FakeClock()
        registry = S.HealthRegistry(now=clock.now)
        sup = S.Supervisor(registry, sleep=clock.sleep,
                           rng=random.Random(7))
        registry.component("absent").disable("no backend here")
        sup.run("absent", 1.0, lambda: None)
        snaps.append(registry.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["components"]["absent"]["state"] == \
        torch_supervise.STATE_DISABLED
    assert snaps[1]["status"] == "ok"


# One script of SinkBreaker calls: (op, arg). "tick" advances the clock.
BREAKER_SCRIPT = [
    ("holds", None), ("failure", "connect refused"), ("holds", None),
    ("holds", None), ("tick", 1.5), ("holds", None),
    ("failure", "connect refused"), ("holds", None), ("tick", 2.5),
    ("holds", None), ("failure", "reset"), ("tick", 4.5), ("holds", None),
    ("success", None), ("holds", None), ("failure", "again"),
]


def _run_breaker(S) -> list:
    clock = FakeClock()
    registry = S.HealthRegistry(now=clock.now)
    comp = registry.component("relay_sink")
    breaker = S.SinkBreaker("relay", comp, retry_initial_s=1.0,
                            retry_max_s=4.0, breaker_failures=2,
                            now=clock.now)
    trail = []
    for op, arg in BREAKER_SCRIPT:
        if op == "tick":
            clock.sleep(arg)
            continue
        got = getattr(breaker, op)(*(() if arg is None else (arg,)))
        trail.append((op, got, breaker.open, breaker.dropped,
                      comp.snapshot()))
    trail.append(registry.snapshot())
    return trail


def test_sink_breakers_agree():
    jax_trail, torch_trail = (_run_breaker(S) for S, _ in PACKAGES)
    assert torch_trail == jax_trail
    assert any(step[2] for step in torch_trail[:-1])  # the breaker opened


def test_version_constants_match_the_jax_mirror(monkeypatch):
    for name in ("BUILD", "PROTO_VERSION", "WAL_RECORD_VERSION",
                 "SNAPSHOT_VERSION", "SNAPSHOT_MIN_VERSION",
                 "WAL_VERSIONED_FLAG", "FLEET_LIVE", "FLEET_STALE",
                 "FLEET_LOST", "PRESSURE_OK", "PRESSURE_SOFT",
                 "PRESSURE_HARD", "STATE_UP", "STATE_RECOVERING",
                 "STATE_DEGRADED", "STATE_DISABLED"):
        assert getattr(torch_supervise, name) == \
            getattr(jax_supervise, name), name
    for value in (None, "0", "1", "3", "junk", "-2"):
        if value is None:
            monkeypatch.delenv("DYNO_COMPAT_LEVEL", raising=False)
        else:
            monkeypatch.setenv("DYNO_COMPAT_LEVEL", value)
        assert torch_supervise.default_compat_level() == \
            jax_supervise.default_compat_level(), value


def test_every_public_name_is_ported():
    public = {n for n in dir(jax_supervise) if not n.startswith("_")}
    public -= {"annotations", "json", "os", "random", "socket", "struct",
               "threading", "time", "zlib", "failpoints"}
    missing = sorted(n for n in public if not hasattr(torch_supervise, n))
    assert not missing, missing
