"""ProcessLauncher: executables run as OS processes, courier over gRPC.

The closest single-machine analogue of a cluster launcher: every service is
its own process with a real network endpoint, so serialization, transport
and failure isolation behave like the distributed setting. A shared
``multiprocessing.Event`` implements cooperative stop in both directions
(parent -> children and any child's ``stop_program()`` -> everyone).

Fault tolerance: a monitor thread watches child processes; non-zero exits
are restarted per the group's RestartPolicy (paper §6 — scheduler restarts;
stateful services are expected to self-restore from checkpoints).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import threading
import time
import uuid
from typing import Optional

from repro_torch.core.courier import shm as courier_shm
from repro_torch.core.fault import NodeFailure
from repro_torch.core.launchers.base import Launcher
from repro_torch.core.launchers.thread import PortReservation
from repro_torch.core.nodes.base import Executable, Node, WorkerContext


def _child_main(payload: bytes, stop_event, node_name: str) -> None:
    """Child entry point. ``payload`` is a cloudpickled executable."""
    import cloudpickle
    executable: Executable = cloudpickle.loads(payload)
    ctx = WorkerContext(node_name=node_name, stop_event=stop_event,
                        stop_program_fn=stop_event.set)
    executable.run(ctx)


class _Managed:
    __slots__ = ("node_name", "group", "payload", "process", "restarts", "done")

    def __init__(self, node_name: str, group: str, payload: bytes):
        self.node_name = node_name
        self.group = group
        self.payload = payload
        self.process: Optional[mp.Process] = None
        self.restarts = 0
        self.done = False


class ProcessLauncher(Launcher):
    launch_type = "process"

    def __init__(self, start_method: str = "fork", monitor_interval_s: float = 0.05,
                 **kwargs):
        super().__init__(**kwargs)
        self._mp = mp.get_context(start_method)
        self._stop_event = self._mp.Event()
        self._managed: list[_Managed] = []
        self._monitor_interval_s = monitor_interval_s
        self._monitor: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._reservations: list[PortReservation] = []
        self._shm_names: list[str] = []

    # -- addresses ------------------------------------------------------------
    def _assign_address(self, node: Node, index: int) -> str:
        # Dual endpoint: same-host peers connect over the shared-memory
        # ring (shm.py); anything that can't — no listener yet after the
        # connect grace, a stale listener from a crashed node, a remote
        # host — falls back to gRPC. The port reservation is held until
        # terminate(), so the advertised port is the one the child binds.
        res = PortReservation()
        self._reservations.append(res)
        grpc_ep = f"grpc://127.0.0.1:{res.port}"
        if not courier_shm.supported():  # pragma: no cover - non-POSIX
            return grpc_ep
        name = f"lp{os.getpid():x}u{index}x{uuid.uuid4().hex[:8]}"
        self._shm_names.append(name)
        return f"shm://{name}+{grpc_ep}"

    # -- execution ---------------------------------------------------------------
    def _spawn(self, managed: _Managed) -> None:
        p = self._mp.Process(
            target=_child_main,
            args=(managed.payload, self._stop_event, managed.node_name),
            name=f"lp/{managed.node_name}", daemon=True)
        p.start()
        managed.process = p

    def _execute(self, node: Node, group_name: str,
                 executables: list[Executable]) -> None:
        import cloudpickle
        for ex in executables:
            managed = _Managed(node.name, group_name, cloudpickle.dumps(ex))
            self._managed.append(managed)
            self._spawn(managed)
        if self._monitor is None:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             name="lp/monitor", daemon=True)
            self._monitor.start()

    # -- monitoring / restarts --------------------------------------------------
    def _monitor_loop(self) -> None:
        # The monitor is the single source of truth for node lifecycle:
        # it marks clean exits done, restarts failures per policy, and only
        # then may wait() observe completion (avoids a race where wait()
        # sees a dead-but-restartable process and declares the program over).
        while True:
            all_done = True
            with self._lock:
                managed_list = list(self._managed)
            for m in managed_list:
                if m.done or m.process is None:
                    continue
                if m.process.is_alive():
                    all_done = False
                    continue
                code = m.process.exitcode
                if code == 0 or self._stop_event.is_set():
                    m.done = True
                    continue
                policy = self.policy_for(m.group)
                fatal = not policy.allows(m.restarts)
                self.record_failure(NodeFailure(
                    node_name=m.node_name,
                    error=RuntimeError(f"process exited with code {code}"),
                    restarts=m.restarts, fatal=fatal))
                if fatal:
                    self.stop()
                    m.done = True
                else:
                    time.sleep(policy.backoff_for(m.restarts))
                    m.restarts += 1
                    self._spawn(m)
                    all_done = False
            if all_done or self._stop_event.is_set():
                return
            time.sleep(self._monitor_interval_s)

    # -- lifecycle -----------------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        done = self._wait_inner(timeout)
        if done:
            self._release_resources()
        return done

    def _wait_inner(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # Completion is judged by the monitor's m.done marks so that a
            # crashed-but-restartable node is never mistaken for "finished".
            pending = [m for m in self._managed if not m.done]
            alive = [m for m in pending
                     if m.process is not None and m.process.is_alive()]
            if not pending:
                return True
            if not alive and all(
                    m.process is not None and m.process.exitcode == 0
                    for m in pending):
                # Clean exits the monitor hasn't marked yet.
                if self._monitor is not None and not self._monitor.is_alive():
                    return True
            if self._stop_event.is_set():
                # Grace period, then hard-terminate stragglers.
                grace_deadline = time.monotonic() + 2.0
                while time.monotonic() < grace_deadline:
                    if not any(m.process.is_alive() for m in alive):
                        return True
                    time.sleep(0.02)
                for m in alive:
                    if m.process.is_alive():
                        m.process.terminate()
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def stop(self) -> None:
        self._stop_event.set()

    def _release_resources(self) -> None:
        for res in self._reservations:
            res.release()
        self._reservations.clear()
        # Hard-killed children never ran their listener teardown: sweep
        # their rendezvous dirs so later clients see "absent", not "stale".
        for name in self._shm_names:
            courier_shm.cleanup(name)

    def terminate(self) -> None:
        """Hard kill (used by tests' teardown)."""
        self._stop_event.set()
        for m in self._managed:
            if m.process is not None and m.process.is_alive():
                m.process.terminate()
        for m in self._managed:
            if m.process is not None:
                m.process.join(timeout=2.0)
        self._release_resources()
