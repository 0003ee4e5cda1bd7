"""ThreadLauncher: every executable is a thread in this process.

This mirrors the open-sourced Launchpad's single-machine launcher. Services
communicate over the in-process courier channel (``inproc://``) unless
``force_grpc=True``, which binds real gRPC servers on localhost — useful
for measuring the RPC overhead the paper discusses, without processes.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from repro_torch.core.fault import NodeFailure
from repro_torch.core.launchers.base import Launcher
from repro_torch.core.nodes.base import Executable, Node, WorkerContext


def pick_free_port() -> int:
    """Ask the kernel for a free port, then release it.

    Inherently racy (pick-then-bind TOCTOU): another process can grab the
    port between return and the server's bind. Launchers should use
    :class:`PortReservation` instead, which *holds* the port until the
    server binds; this stays for callers that only need a probably-free
    port.
    """
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class PortReservation:
    """A port the kernel bound for us and that we keep holding.

    Closes the pick-free-port TOCTOU window: the reservation socket is
    bound with SO_REUSEPORT and *stays open* (never listening, so it
    receives no connections) while the courier server — which also binds
    with SO_REUSEPORT (pinned in ``_GRPC_OPTIONS``) — binds the same
    port. No other port-0 allocation can be handed this port while the
    reservation lives, so the endpoint written into the address table is
    the port the server actually binds. On platforms without
    SO_REUSEPORT this degrades to the legacy racy pick.
    """

    def __init__(self, host: str = "127.0.0.1"):
        self._sock: Optional[socket.socket] = None
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        reuseport = getattr(socket, "SO_REUSEPORT", None)
        if reuseport is None:  # pragma: no cover - non-Linux fallback
            s.close()
            self.port = pick_free_port()
            return
        s.setsockopt(socket.SOL_SOCKET, reuseport, 1)
        s.bind((host, 0))
        self.port = s.getsockname()[1]
        self._sock = s

    def release(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class ThreadLauncher(Launcher):
    launch_type = "thread"

    def __init__(self, force_grpc: bool = False, **kwargs):
        super().__init__(**kwargs)
        self._force_grpc = force_grpc
        self._stop_event = threading.Event()
        self._threads: list[threading.Thread] = []
        self._reservations: list[PortReservation] = []

    # -- addresses ------------------------------------------------------------
    def _assign_address(self, node: Node, index: int) -> str:
        if self._force_grpc:
            # Reservation held until stop(): the port in the address table
            # is the port the server binds (no pick-then-bind race).
            res = PortReservation()
            self._reservations.append(res)
            return f"grpc://127.0.0.1:{res.port}"
        return f"inproc://{node.name}/{index}"

    # -- execution ------------------------------------------------------------
    def _execute(self, node: Node, group_name: str,
                 executables: list[Executable]) -> None:
        policy = self.policy_for(group_name)

        for ex in executables:
            def _runner(ex: Executable = ex, node_name: str = node.name):
                restarts = 0
                while not self._stop_event.is_set():
                    ctx = WorkerContext(node_name=node_name,
                                        stop_event=self._stop_event,
                                        stop_program_fn=self.stop)
                    try:
                        ex.run(ctx)
                        return  # clean completion
                    except BaseException as exc:  # noqa: BLE001
                        fatal = not policy.allows(restarts)
                        self.record_failure(NodeFailure(
                            node_name=node_name, error=exc,
                            restarts=restarts, fatal=fatal))
                        if fatal:
                            # A node out of restart budget takes the program
                            # down (fail-fast beats a silently degraded job).
                            self.stop()
                            return
                        time.sleep(policy.backoff_for(restarts))
                        restarts += 1

            t = threading.Thread(target=_runner, name=f"lp/{ex.name}", daemon=True)
            self._threads.append(t)
            t.start()

    # -- lifecycle --------------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._threads:
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
                if remaining == 0.0:
                    return False
            t.join(remaining)
            if t.is_alive():
                return False
        # Clean completion without stop(): the reserved ports' job is done
        # once every server has exited.
        for res in self._reservations:
            res.release()
        self._reservations.clear()
        return True

    def stop(self) -> None:
        self._stop_event.set()
        for res in self._reservations:
            res.release()
        self._reservations.clear()

    @property
    def fatal_failures(self) -> list[NodeFailure]:
        return [f for f in self.failures if f.fatal]
