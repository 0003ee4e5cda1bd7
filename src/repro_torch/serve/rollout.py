"""Zero-downtime weight rollout for the serve fabric.

The fabric (Registry + Routers + EngineServers) treats its N replicas as
one immutable deployment; this module adds the model lifecycle on top:
rolling the fleet from version A to version B **one replica at a time**,
with health gates and instant rollback, while clients keep getting
answers. The state machine per replica:

    drain  — ``Registry.set_draining(name, True)``: the replica stays
             registered and heartbeating but routers stop picking it;
             its in-flight requests finish on it, new ones go to
             siblings. Capacity dips to N−1 dispatchable, never lower.
    swap   — ``EngineServer.load_version(v)``: weights restore from the
             :class:`~repro_torch.ckpt.checkpoint.ModelStore` and install
             between decode windows (shape-identical, so the compiled
             ladder stays warm — see ``ServeEngine.swap_params``).
    probe  — post-swap health gate: the replica must answer ``health()``
             healthy *and* report the new version. Failing the gate is
             grounds for fleet-wide rollback, not a shrug.
    canary — after the FIRST replica swaps, the routers pin a traffic
             fraction to the new version (``Router.set_canary``) and the
             controller compares the per-version latency/error rows.
             Regression past threshold → rollback. Pass → promote: roll
             the remaining replicas the same drain/swap/probe way.

**No separate source of truth.** The controller keeps no durable state:
which replica serves which version lives in the Registry's version table
(each replica's heartbeat load report carries its loaded version), and
``rollout()`` re-reads that table as it goes. A controller that dies
mid-rollout and restarts simply calls ``rollout()`` again: replicas
already at the target are skipped, half-done work is finished, and a
halted rollout's ``rollback()`` re-derives exactly which replicas to
re-pin. A replica that dies mid-drain is detected (its load probe fails
or it falls out of the table), reported to the registry, and skipped —
its in-flight requests fail over through the router like any crash.

Rollback is *instant* by design: no drain on the way back. The engine
still installs the old weights between decode windows, so requests in
flight on a bad canary complete — a few tokens may be sampled under
mixed versions, which is the accepted cost of getting a regressing model
out of the serving path in one RPC per replica.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence

from repro_torch.core import courier, telemetry


def _vkey(version: Any) -> Optional[str]:
    return None if version is None else str(version)


class RolloutController:
    """Drives drain → swap → probe → canary → promote/rollback.

    ``registry`` and ``routers`` are duck-typed (courier clients/handles
    or in-process objects). ``client_factory`` builds a client for a
    replica endpoint (defaults to :func:`repro_torch.core.courier.client_for`).

    Canary gate: after the first replica swaps, ``canary_fraction`` of
    traffic is pinned to the new version until ``canary_requests``
    completions (or ``canary_timeout_s``); the new version fails the gate
    when its p50 latency exceeds ``regression_ratio`` × the old
    version's, or its error rate exceeds the old one's by more than
    ``error_rate_margin``. With no routers (or ``canary_requests=0``)
    the canary phase is skipped — a plain health-gated rolling restart.
    """

    def __init__(self, registry: Any, routers: Sequence[Any] = (), *,
                 client_factory: Optional[Callable[[str], Any]] = None,
                 drain_timeout_s: float = 30.0,
                 poll_s: float = 0.01,
                 canary_fraction: float = 0.25,
                 canary_requests: int = 8,
                 canary_timeout_s: float = 30.0,
                 regression_ratio: float = 2.0,
                 error_rate_margin: float = 0.05):
        self._registry = registry
        self._routers = list(routers)
        self._client_factory = client_factory or courier.client_for
        self._drain_timeout = drain_timeout_s
        self._poll = poll_s
        self._canary_fraction = canary_fraction
        self._canary_requests = canary_requests
        self._canary_timeout = canary_timeout_s
        self._ratio = regression_ratio
        self._err_margin = error_rate_margin

    # -- registry views ------------------------------------------------------
    def _table(self) -> dict:
        return self._registry.version_table()

    def _baseline_version(self, table: dict, target: Any) -> Optional[Any]:
        """The version the fleet is rolling *from*: the most common
        non-target version in the live table (re-derived, so a restarted
        controller mid-rollout still rolls back to the right place)."""
        counts: dict[str, tuple[int, Any]] = {}
        for info in table.values():
            v = info.get("version")
            if v is None or _vkey(v) == _vkey(target):
                continue
            key = _vkey(v)
            n, _ = counts.get(key, (0, v))
            counts[key] = (n + 1, v)
        if not counts:
            return None
        return max(counts.values())[1]

    # -- single-replica state machine ----------------------------------------
    def _undrain(self, name: str) -> None:
        try:
            self._registry.set_draining(name, False)
        except Exception:  # noqa: BLE001 - registry hiccup: TTL-safe
            pass

    def _probe_dead(self, name: str, client: Any) -> bool:
        """A swap or health RPC just failed: is the replica DEAD (crashed
        — report it and skip) or alive-but-refusing (bad version — roll
        back)? Dead shows as the name already gone from the table, the
        health probe raising, or health reporting a non-ok status (an
        engine that was killed under its still-responding server). A
        genuinely alive replica answers ok on the spot."""
        if name not in self._table():
            return True
        try:
            healthy = client.health().get("status") == "ok"
        except BaseException:  # noqa: BLE001 - transport/replica died
            healthy = False
        if healthy:
            return False
        try:
            self._registry.report_failure(name)
        except Exception:  # noqa: BLE001 - registry hiccup: TTL-safe
            pass
        return True

    def _wait_drained(self, name: str, client: Any) -> str:
        """Until the replica has no queued or in-flight work. Returns
        ``drained`` | ``dead`` | ``timeout``. A replica killed mid-drain
        is the expected chaos case: detect it, evict it, move on."""
        deadline = time.monotonic() + self._drain_timeout
        while time.monotonic() < deadline:
            if name not in self._table():       # evicted (TTL or report)
                return "dead"
            try:
                load = client.load()
            except BaseException:  # noqa: BLE001 - transport/replica died
                try:
                    self._registry.report_failure(name)
                except Exception:  # noqa: BLE001
                    pass
                return "dead"
            slots = int(load.get("num_slots", 0))
            if (int(load.get("free_slots", 0)) >= slots
                    and int(load.get("queue_depth", 0)) == 0):
                return "drained"
            time.sleep(self._poll)
        return "timeout"

    def _roll_one(self, name: str, endpoint: str, target: Any) -> str:
        """drain → swap → probe one replica. Returns ``swapped`` |
        ``dead`` | ``drain_timeout`` | ``swap_failed`` | ``unhealthy``."""
        try:
            client = self._client_factory(endpoint)
        except BaseException:  # noqa: BLE001 - unreachable endpoint
            return "dead"
        self._registry.set_draining(name, True)
        telemetry.record_event("drain", cause=f"rollout to v{target}",
                               replica=name)
        print(f"rollout: draining {name}", flush=True)
        state = self._wait_drained(name, client)
        if state == "dead":
            print(f"rollout: {name} died mid-drain; skipping", flush=True)
            return "dead"
        if state == "timeout":
            self._undrain(name)
            return "drain_timeout"
        try:
            client.load_version(target)
        except BaseException as exc:  # noqa: BLE001 - bad version/transport
            if self._probe_dead(name, client):
                print(f"rollout: {name} died before swap; skipping",
                      flush=True)
                return "dead"
            print(f"rollout: {name} swap to v{target} failed ({exc!r})",
                  flush=True)
            return "swap_failed"
        try:
            health = client.health()
        except BaseException:  # noqa: BLE001
            return "dead" if self._probe_dead(name, client) else "unhealthy"
        if (health.get("status") != "ok"
                or _vkey(health.get("version")) != _vkey(target)):
            return "dead" if self._probe_dead(name, client) else "unhealthy"
        self._undrain(name)
        telemetry.record_event("swap", cause=f"now serving v{target}",
                               replica=name)
        print(f"rollout: {name} now serving v{target}", flush=True)
        return "swapped"

    # -- canary gate ---------------------------------------------------------
    def _per_version_rows(self) -> dict:
        merged: dict[str, dict] = {}
        for router in self._routers:
            try:
                rows = router.stats().get("per_version", {})
            except BaseException:  # noqa: BLE001 - router mid-restart
                continue
            for key, row in rows.items():
                agg = merged.setdefault(key, {"completed": 0, "errors": 0,
                                              "lat_us_sum": 0.0})
                agg["completed"] += row["completed"]
                agg["errors"] += row["errors"]
                # Completion-weighted p50 average across routers.
                agg["lat_us_sum"] += row["p50_lat_us"] * row["completed"]
        for agg in merged.values():
            agg["p50_lat_us"] = agg["lat_us_sum"] / (agg["completed"] or 1)
        return merged

    def _set_canary(self, version: Optional[Any], fraction: float) -> None:
        for router in self._routers:
            try:
                router.set_canary(version, fraction)
            except BaseException:  # noqa: BLE001
                pass

    def _canary_verdict(self, target: Any, baseline: Any) -> dict:
        """Pin traffic to the canary, wait for samples, compare rows."""
        tkey, bkey = _vkey(target), _vkey(baseline)
        start = self._per_version_rows().get(tkey, {})
        already = start.get("completed", 0)
        self._set_canary(target, self._canary_fraction)
        deadline = time.monotonic() + self._canary_timeout
        rows: dict = {}
        while time.monotonic() < deadline:
            rows = self._per_version_rows()
            done = rows.get(tkey, {}).get("completed", 0) - already
            if done >= self._canary_requests:
                break
            time.sleep(self._poll)
        self._set_canary(None, 0.0)
        canary = rows.get(tkey, {"completed": 0, "errors": 0,
                                 "p50_lat_us": 0.0})
        base = rows.get(bkey) if bkey is not None else None
        verdict = {"canary": {k: canary.get(k) for k in
                              ("completed", "errors", "p50_lat_us")},
                   "baseline": None if base is None else
                               {k: base.get(k) for k in
                                ("completed", "errors", "p50_lat_us")}}
        samples = canary["completed"] - already
        if samples < self._canary_requests:
            # Not enough canary traffic to judge (idle fabric): health
            # probes already passed — promote, but say so.
            verdict.update(ok=True, reason=f"short sample ({samples})")
            return verdict
        if base is not None and base["completed"] > 0:
            c_rate = canary["errors"] / max(canary["completed"], 1)
            b_rate = base["errors"] / base["completed"]
            if c_rate > b_rate + self._err_margin:
                verdict.update(ok=False,
                               reason=f"error rate {c_rate:.3f} vs "
                                      f"{b_rate:.3f}")
                return verdict
            if (base["p50_lat_us"] > 0
                    and canary["p50_lat_us"]
                        > self._ratio * base["p50_lat_us"]):
                verdict.update(
                    ok=False,
                    reason=f"p50 {canary['p50_lat_us']:.0f}us > "
                           f"{self._ratio:g}x baseline "
                           f"{base['p50_lat_us']:.0f}us")
                return verdict
        verdict.update(ok=True, reason="within thresholds")
        return verdict

    # -- fleet operations ----------------------------------------------------
    def rollback(self, old: Any, target: Any,
                 extra: Sequence[str] = ()) -> dict:
        """Re-pin every replica the table says is at ``target`` back to
        ``old`` — instant (no drain), idempotent, re-derivable: safe to
        call from a restarted controller that only knows the two
        versions. ``extra`` names replicas known-swapped this run whose
        heartbeat may not have carried the new version yet (the table
        lags one beat period)."""
        self._set_canary(None, 0.0)
        telemetry.record_event("rollback", cause=f"re-pinning fleet to v{old}",
                               target=str(target))
        outcomes: dict[str, str] = {}
        for name, info in sorted(self._table().items()):
            if (_vkey(info.get("version")) != _vkey(target)
                    and name not in extra):
                self._undrain(name)     # clear any leftover drain marks
                continue
            try:
                client = self._client_factory(info["endpoint"])
                client.load_version(old)
                outcomes[name] = "restored"
            except BaseException as exc:  # noqa: BLE001 - dead replica
                outcomes[name] = f"failed ({exc!r})"
            self._undrain(name)
        print(f"rollout: rolled back to v{old} ({outcomes})", flush=True)
        return outcomes

    def rollout(self, target: Any) -> dict:
        """Roll the live fleet to ``target``, one replica at a time.

        Returns a summary dict with ``status`` ``promoted`` (every live
        replica serves ``target``) or ``rolled_back`` (a health gate or
        the canary comparison failed; every live replica was re-pinned to
        the version the fleet was on). Restart-safe: all progress state
        is re-read from the registry's version table, so calling this
        again after a controller crash resumes where it left off.
        """
        t0 = time.monotonic()
        table = self._table()
        if not table:
            return {"status": "no_replicas", "target": target}
        baseline = self._baseline_version(table, target)
        outcomes: dict[str, str] = {}
        canary_verdict: Optional[dict] = None
        canary_pending = bool(self._routers) and self._canary_requests > 0
        while True:
            # Fresh view every iteration: replicas already at target
            # (including ones a previous controller incarnation rolled)
            # are skipped; new arrivals at the old version are picked up.
            # ``outcomes`` only guards against *this run* re-touching a
            # replica whose heartbeat hasn't carried the new version yet
            # (the table lags one beat) or one that already died on us.
            table = self._table()
            pending = [(name, info) for name, info in sorted(table.items())
                       if _vkey(info.get("version")) != _vkey(target)
                       and outcomes.get(name) not in ("swapped", "dead")]
            if not pending:
                break
            name, info = pending[0]
            outcome = self._roll_one(name, info["endpoint"], target)
            outcomes[name] = outcome
            if outcome == "dead":
                continue
            if outcome != "swapped":
                if baseline is not None:
                    self.rollback(baseline, target,
                                  extra=[n for n, o in outcomes.items()
                                         if o == "swapped"])
                return {"status": "rolled_back", "target": target,
                        "baseline": baseline, "replicas": outcomes,
                        "canary": canary_verdict,
                        "reason": f"{name}: {outcome}",
                        "duration_s": time.monotonic() - t0}
            if canary_pending:
                canary_pending = False
                # Only a comparison when someone still serves baseline.
                if any(_vkey(i.get("version")) == _vkey(baseline)
                       for i in self._table().values()):
                    canary_verdict = self._canary_verdict(target, baseline)
                    if not canary_verdict["ok"]:
                        self.rollback(baseline, target,
                                      extra=[n for n, o in outcomes.items()
                                             if o == "swapped"])
                        return {"status": "rolled_back", "target": target,
                                "baseline": baseline, "replicas": outcomes,
                                "canary": canary_verdict,
                                "reason": "canary: "
                                          + canary_verdict["reason"],
                                "duration_s": time.monotonic() - t0}
        self._set_canary(None, 0.0)
        return {"status": "promoted", "target": target,
                "baseline": baseline, "replicas": outcomes,
                "canary": canary_verdict,
                "duration_s": time.monotonic() - t0}
