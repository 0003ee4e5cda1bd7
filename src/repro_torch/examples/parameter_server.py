"""Parameter server (paper §5.1, Listings 3/4, Figure 2).

Three topologies over the same services, selected by --mode:
  single      one server, N requesters (Listing 3)
  replicated  servers replicated behind the Registry; requesters resolve
              by role and fail over (Listing 4 left, fabric edition)
  cached      one server behind a CacherNode (Listing 4 right)

The replicated topology rides the discovery fabric: each server
heartbeats its endpoint + served count into the Registry; requesters
resolve a server by role (partitioned by requester index), and on an RPC
failure report it (report_failure -> eviction) and re-resolve. That is
what --kill-after demonstrates: one server dies mid-run, its requesters
fail over to a sibling, total QPS dips but the run completes.

Nothing here computes on a device; ``--device`` is checked as in every
example.

    PYTHONPATH=src python -m repro_torch.examples.parameter_server \
        --device cpu --mode cached --requesters 8 --seconds 2
    PYTHONPATH=src python -m repro_torch.examples.parameter_server \
        --device cpu --mode replicated --requesters 8 --seconds 2 \
        --kill-after 0.5
"""

import random
import threading
import time

from repro_torch import core as lp
from repro_torch.examples import _cli


class ParamServer:
    """1 ms simulated parameter fetch (the paper's workload). With a
    registry it advertises itself like an engine replica
    (role=param-server) and exposes the chaos hooks (kill/stall)."""

    def __init__(self, registry=None, name="server-0", heartbeat_s=0.1):
        self._served = 0
        self._dead = False
        self._name = name
        self._heartbeater = None
        if registry is not None:
            ctx = lp.get_current_context()
            self._heartbeater = lp.Heartbeater(
                registry, name, ctx.endpoint or f"inproc://{name}",
                load_fn=self.load, period_s=heartbeat_s,
                stop_event=ctx.stop_event).start()

    def load(self):
        return {"role": "param-server", "served": self._served}

    def kill(self):
        """Die unannounced: RPCs fail, heartbeats stop, the registry
        evicts via TTL (or sooner, via a requester's report_failure)."""
        self._dead = True
        if self._heartbeater is not None:
            self._heartbeater.stop(deregister=False)

    def stall(self, seconds):
        if self._heartbeater is not None:
            self._heartbeater.pause(seconds)

    def get_value(self):
        if self._dead:
            raise ConnectionError(f"{self._name} is dead")
        time.sleep(0.001)   # paper: 1ms simulated parameter-fetch delay
        self._served += 1
        return random.random()


class Requester:
    """Polls a server as fast as it can; reports its QPS to a meter.

    With a direct ``server`` handle this is Listing 3 verbatim. With a
    ``registry`` it resolves a live param-server by role instead, and
    fails over on error: report_failure evicts the dead server, the
    re-resolve lands on a survivor.
    """

    def __init__(self, meter, server=None, registry=None, index=0):
        self._meter = meter
        self._server = server
        self._registry = registry
        self._index = index
        self._resolved_name = None

    def _resolve(self):
        replicas = [r for r in self._registry.lookup()["replicas"]
                    if r["load"].get("role") == "param-server"
                    and not r.get("draining")]
        if not replicas:
            return None
        r = replicas[self._index % len(replicas)]
        self._resolved_name = r["name"]
        return lp.courier.client_for(r["endpoint"])

    def run(self):
        ctx = lp.get_current_context()
        server = self._server
        while not ctx.should_stop:
            if server is None:               # registry mode: (re-)resolve
                server = self._resolve()
                if server is None:           # nobody live yet / mid-failover
                    ctx.wait_for_stop(0.01)
                    continue
            try:
                server.get_value()
            except Exception:  # noqa: BLE001
                if self._registry is None:
                    raise                    # direct handle: let it surface
                try:
                    self._registry.report_failure(self._resolved_name)
                except Exception:  # noqa: BLE001
                    pass
                server = None
                continue
            self._meter.count(1)


class Meter:
    def __init__(self, seconds: float):
        self._n = 0
        self._lock = threading.Lock()
        self._seconds = seconds

    def count(self, k: int):
        with self._lock:
            self._n += k

    def run(self):
        time.sleep(self._seconds)
        with self._lock:
            qps = self._n / self._seconds
        print(f"total QPS: {qps:,.0f}")
        lp.stop_program()


def build(mode: str, num_requesters: int, seconds: float,
          num_servers: int = 4, cache_timeout: float = 0.01,
          kill_after=None) -> lp.Program:
    p = lp.Program(f"ps-{mode}")
    meter = p.add_node(lp.CourierNode(Meter, seconds))

    if mode == "single":
        with p.group("server"):
            server = p.add_node(lp.CourierNode(ParamServer))
        requesters = [dict(server=server)] * num_requesters
    elif mode == "replicated":
        with p.group("registry"):
            registry = p.add_node(lp.CourierNode(lp.Registry, ttl_s=2.0))
        with p.group("server"):
            for i in range(num_servers):
                p.add_node(lp.CourierNode(ParamServer, registry,
                                          name=f"server-{i}"))
        requesters = [dict(registry=registry, index=i)
                      for i in range(num_requesters)]
        if kill_after is not None:
            from repro_torch.train.fabric import ChaosNode
            with p.group("chaos"):
                p.add_node(lp.PyNode(
                    ChaosNode, registry,
                    [("kill", "server-0", kill_after, 0.0)]))
    elif mode == "cached":
        with p.group("server"):
            server = p.add_node(lp.CourierNode(ParamServer))
        with p.group("cacher"):
            cacher = p.add_node(lp.CacherNode(server, timeout_s=cache_timeout))
        requesters = [dict(server=cacher)] * num_requesters
    else:
        raise ValueError(mode)
    if kill_after is not None and mode != "replicated":
        raise ValueError("--kill-after needs --mode replicated (the other "
                         "topologies have no failover path)")

    with p.group("requester"):
        for kwargs in requesters:
            p.add_node(lp.CourierNode(Requester, meter, **kwargs))
    return p


def main(argv=None):
    ap = _cli.parser(__doc__.splitlines()[0])
    ap.add_argument("--mode", default="cached",
                    choices=["single", "replicated", "cached"])
    ap.add_argument("--requesters", type=int, default=8)
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--kill-after", type=float, default=None,
                    help="chaos demo (replicated only): kill server-0 this "
                         "many seconds after it registers; its requesters "
                         "fail over to the surviving replicas")
    args = ap.parse_args(argv)
    _cli.checked_device(args.device)
    program = build(args.mode, args.requesters, args.seconds,
                    num_servers=args.servers, kill_after=args.kill_after)
    print(program)
    lp.launch_and_wait(program, timeout_s=args.seconds + 30)


if __name__ == "__main__":
    main()
