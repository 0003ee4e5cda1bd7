"""A mesh of D·M processes driven by one controller.

A torch ``DeviceMesh`` spans one process per device, while a Launchpad
training program is one process, as the JAX package's is: one
controller, one batch, one mesh that every learner thread shares.
``MeshGroup`` keeps that shape. The program's own process is rank 0;
ranks 1..D·M-1 are *followers*, fresh interpreters running this module
(``python -m repro_torch.train.mesh_group``, never a fork: a child
forked from a process that had run gloo groups never came up). They
meet at a ``TCPStore`` on a port the OS picks, with rank r on the
device ``sharding.compat.rank_devices`` gives it.

Followers run no courier, registry or heartbeat; they hear only the
group. Before a learner on rank 0 runs work that has collectives, it
broadcasts one command (its name, its incarnation, the method and the
method's arguments, numpy as numpy), then runs the method itself. Each
follower keeps one mirror ``LearnerWorker`` a learner name (no batch
source, no registry, no store writes) and calls the same method on it,
so every rank runs the same torch ops in the same order. Rank 0 holds
``MESH_LOCK`` across a command and its collectives, so no two learners'
collectives, nor the exit command, interleave.

A follower that dies ends the program with an error: ``check`` (which
the supervisor calls every poll) and every later command see the dead
process and raise; a collective already in flight fails when gloo sees
the closed connection, or at the group's timeout. ``close`` waits for
the command in flight, sends the exit command, and reaps the followers
under a timeout, killing any that outlive it. A follower prints one
JSON line as it exits 0: its rank, its device and its mirrors' state.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import itertools
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.sharding import compat

# The group's collective and rendezvous timeout: a follower waits this
# long for rank 0's next command, and a collective with a hung rank fails
# after it.
GROUP_TIMEOUT_S = 1800.0
# How long ``close`` gives the followers to exit once told to.
REAP_TIMEOUT_S = 30.0
_CPU = torch.device("cpu")
# The sharding context and DTensor's implicit replication are the
# process's, and so is the group: mesh learners of one process take turns,
# each holding this lock across one command and its collectives
# (``LearnerWorker.on_ranks``), and ``close`` holds it across the exit.
MESH_LOCK = threading.RLock()


@dataclasses.dataclass
class Command:
    """One command from rank 0: ``op`` is "construct", "call", "drop" or
    "exit"; a "call" runs ``method(**kwargs)`` on the mirror
    of learner ``name`` in ``incarnation``."""
    op: str
    name: str = ""
    incarnation: int = 0
    method: str = ""
    kwargs: dict = dataclasses.field(default_factory=dict)


def _send(cmd: Optional[Command]) -> Command:
    """Broadcast ``cmd`` from rank 0 (``None`` on a follower, which
    returns what rank 0 sent), over gloo on the CPU whatever the
    devices."""
    box = [cmd]
    dist.broadcast_object_list(box, src=0, device=_CPU)
    return box[0]


class MeshGroup:
    """Rank 0's side: starts the followers and the group, builds the
    mesh, and sends the commands. ``device`` is the program's: "cpu",
    or "cuda" for one card a rank."""

    def __init__(self, axis_shapes: Sequence[int],
                 axis_names: Sequence[str], device):
        shape = tuple(int(s) for s in axis_shapes)
        devices = compat.rank_devices(shape, device)
        self.world = len(devices)
        self._incarnations = itertools.count(1)
        self._failure: Optional[str] = None
        self._closed = False
        store = dist.TCPStore("127.0.0.1", 0, self.world, True,
                              timeout=datetime.timedelta(
                                  seconds=GROUP_TIMEOUT_S),
                              wait_for_workers=False)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        argv = ["--port", str(store.port), "--mesh",
                ",".join(map(str, shape)), "--axes", ",".join(axis_names),
                "--device", str(device),
                "--threads", str(torch.get_num_threads())]
        self._procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.train.mesh_group",
             "--rank", str(r), *argv], env=env)
            for r in range(1, self.world)]
        try:
            self._await_followers(store)
            self.device = compat.start_group(store, 0, devices,
                                             GROUP_TIMEOUT_S)
            self.mesh = compat.make_mesh(shape, axis_names,
                                         self.device.type)
        except BaseException:
            self._kill()
            raise
        self._store = store          # the followers' rendezvous: keep it up

    def _await_followers(self, store) -> None:
        """Wait until every follower has imported the port and reached
        the store, failing at once if one exits first."""
        keys = [f"ready/{r}" for r in range(1, self.world)]
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        while not store.check(keys):
            for r, p in enumerate(self._procs, start=1):
                if p.poll() is not None:
                    raise RuntimeError(f"mesh rank {r} exited with code "
                                       f"{p.returncode} before the group "
                                       "formed")
            if time.monotonic() > deadline:
                raise RuntimeError("mesh followers did not reach the store "
                                   f"in {GROUP_TIMEOUT_S} s")
            time.sleep(0.05)

    def _dead_follower(self) -> Optional[str]:
        for r, p in enumerate(self._procs, start=1):
            if p.poll() is not None:
                return f"mesh rank {r} exited with code {p.returncode}"
        return None

    def _failed(self) -> Optional[str]:
        """Why the group takes no more commands: a follower that died
        before ``close`` told it to exit, or ``fail``'s reason."""
        if self._failure is None and not self._closed:
            self._failure = self._dead_follower()
        return self._failure

    @property
    def pids(self) -> list[int]:
        """The followers' process ids, rank 1 first (for an operator's
        signals; the tests kill a follower by it)."""
        return [p.pid for p in self._procs]

    def check(self) -> None:
        """Raise ``RuntimeError`` once a follower has died or the ranks
        have fallen out of step (``fail``)."""
        if self._failed() is not None:
            raise RuntimeError(self._failure)

    def fail(self, reason: str) -> None:
        """Rank 0's side of a command failed, so the followers may wait
        in a collective that rank 0 will never run: the group takes no
        more commands, and ``close`` kills the followers. A follower's
        death, the usual cause, is named first."""
        if self._failure is None:
            dead = self._dead_follower()
            self._failure = reason if dead is None else f"{dead}: {reason}"

    def _command(self, cmd: Command) -> None:
        if self._closed:
            raise RuntimeError("the mesh group is closed")
        self.check()
        _send(cmd)

    # -- what the learners send (under MESH_LOCK) -----------------------------
    def construct(self, name: str, **kwargs) -> int:
        """Build (or rebuild, dropping the old one) the mirror of learner
        ``name`` on every follower from ``LearnerWorker.mirror``'s
        arguments; returns the new incarnation."""
        incarnation = next(self._incarnations)
        self._command(Command("construct", name, incarnation,
                              kwargs=kwargs))
        return incarnation

    def call(self, name: str, incarnation: int, method: str,
             kwargs: dict) -> None:
        """Have every follower run ``method(**kwargs)`` on its mirror."""
        self._command(Command("call", name, incarnation, method, kwargs))

    def drop(self, name: str, incarnation: int) -> None:
        """A killed or retired learner's mirrors go; nothing to do once
        the group has ended."""
        if self._closed or self._failure is not None:
            return
        self._command(Command("drop", name, incarnation))

    # -- the end --------------------------------------------------------------
    def close(self) -> None:
        """Wait for the command in flight and its collectives to end
        (``MESH_LOCK``), send the exit command and reap the followers;
        any still running after ``REAP_TIMEOUT_S`` are killed. A group
        that has failed, or fails while ``close`` waits, gets no exit
        command: its followers are killed, which also ends a rank-0
        collective stuck on them. Ends the group on rank 0, and raises
        if a follower had died."""
        locked = False
        while not (locked or self._closed or self._failed()):
            locked = MESH_LOCK.acquire(timeout=0.1)
        self._closed = True          # the followers' exits are expected now
        timer = threading.Timer(REAP_TIMEOUT_S, self._kill)
        timer.start()
        try:
            if locked:
                _send(Command("exit"))
                for p in self._procs:
                    p.wait()
        finally:
            if locked:
                MESH_LOCK.release()
            timer.cancel()
            self._kill()
            if dist.is_initialized():
                dist.destroy_process_group()
        codes = [p.returncode for p in self._procs]
        if self._failure is None and any(codes):
            self._failure = f"mesh followers exited with codes {codes}"
        self.check()

    def _kill(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
            p.wait()


# ---------------------------------------------------------------------------
# the follower
# ---------------------------------------------------------------------------

def follow(argv=None) -> int:
    """A follower's life: join the group, build the mesh, then run rank
    0's commands on the learners' mirrors until "exit"."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--axes", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--threads", type=int, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    from repro_torch.train.fabric import LearnerWorker

    shape = tuple(int(s) for s in args.mesh.split(","))
    devices = compat.rank_devices(shape, args.device)
    store = dist.TCPStore(
        "127.0.0.1", args.port, len(devices), False,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    store.set(f"ready/{args.rank}", "1")
    device = compat.start_group(store, args.rank, devices, GROUP_TIMEOUT_S)
    mesh = compat.make_mesh(shape, args.axes.split(","), device.type)
    mirrors: dict[str, Any] = {}
    while True:
        cmd = _send(None)
        if cmd.op == "exit":
            print(json.dumps({"mesh_rank": args.rank, "device": str(device),
                              "learners": {name: m.mirror_state() for
                                           name, m in mirrors.items()}}),
                  flush=True)
            break
        if cmd.op == "construct":
            mirrors.pop(cmd.name, None)     # free the old shards first
            mirrors[cmd.name] = LearnerWorker.mirror(
                name=cmd.name, incarnation=cmd.incarnation, mesh=mesh,
                **cmd.kwargs)
        elif cmd.op == "drop":
            mirrors.pop(cmd.name, None)
        elif cmd.op == "call":
            mirror = mirrors.get(cmd.name)
            if mirror is None or mirror.incarnation != cmd.incarnation:
                raise RuntimeError(
                    f"rank {args.rank}: {cmd.method} for {cmd.name} "
                    f"incarnation {cmd.incarnation}, which it does not hold")
            mirror.on_ranks(cmd.method, **cmd.kwargs)
        else:
            raise RuntimeError(f"rank {args.rank}: unknown command {cmd.op}")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(follow())
