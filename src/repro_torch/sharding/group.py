"""A mesh of D·M processes driven by one controller.

A torch ``DeviceMesh`` spans one process per device, while a Launchpad
program is one process per node, as the JAX package's is: one controller
over a mesh of the process's devices. ``MeshGroup`` keeps that shape.
The controlling process is rank 0; ranks 1..D·M-1 are *followers*, fresh
interpreters running this module (``python -m
repro_torch.sharding.group``, never a fork: a child forked from a process
that had run gloo groups never came up). They meet at a ``TCPStore`` on
a port the OS picks, with rank r on the device
``sharding.compat.rank_devices`` gives it.

Followers run no courier, registry or heartbeat; they hear only the
group, over one command protocol:

* ``construct`` builds object ``name`` on every follower from a factory
  named by reference (module and qualified name, ``reference``) and its
  arguments, plus ``mesh=`` the follower's part of the mesh. The
  training program's learners send ``LearnerWorker.mirror``; a
  ``MeshWorkerNode`` sends its wrapped class.
* ``call`` runs ``method(*args, **kwargs)`` on object ``name`` of that
  incarnation; ``drop`` frees it; ``exit`` ends the follower.

Rank 0 runs the same work through ``MeshGroup.on_ranks``: under
``MESH_LOCK`` it broadcasts the call (numpy as numpy), then runs the
method itself, so every rank runs the same torch ops and collectives in
the same order, and no two objects' collectives, nor the exit command,
interleave. Rank 0's result is the caller's; a follower's stays with it.

A follower imports what a command names as ``multiprocessing``'s spawn
does: it takes rank 0's ``sys.path``, and re-runs rank 0's main module
under the name ``__mp_main__`` (by its module name under ``python -m``,
else by its file), so a class defined in a program file is found, and
that file must guard its entry point with ``if __name__ ==
"__main__"``. A class local to a function, or defined under ``python
-c``, cannot be found: ``reference`` refuses it.

A follower that dies ends the program with an error that names its rank
(and, when it failed on a command, its exception): ``check`` and every
later command see the dead process and raise; a collective already in
flight fails when gloo sees the closed connection, or at the group's
timeout. ``close`` waits for the command in flight, sends the exit
command, and reaps the followers under a timeout, killing any that
outlive it. A follower prints one JSON line as it exits 0: its rank, its
device and its objects' incarnations and ``mirror_state()``.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import itertools
import json
import os
import runpy
import subprocess
import sys
import threading
import time
import types
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
# process's, and so is the group: the objects of one process take turns,
# each holding this lock across one command and its collectives
# (``MeshGroup.on_ranks``), and ``close`` holds it across the exit.
MESH_LOCK = threading.RLock()
# Set while this thread runs a call that the followers replay.
_replaying = threading.local()


@dataclasses.dataclass
class Command:
    """One command from rank 0: ``op`` is "construct", "call", "drop" or
    "exit". A "construct" builds object ``name`` in ``incarnation`` as
    ``factory(*args, mesh=<mesh>, **kwargs)``, ``factory`` a (module,
    qualified name) reference; a "call" runs ``method(*args, **kwargs)``
    on it."""
    op: str
    name: str = ""
    incarnation: int = 0
    method: str = ""
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    factory: tuple = ()


def _send(cmd: Optional[Command]) -> Command:
    """Broadcast ``cmd`` from rank 0 (``None`` on a follower, which
    returns what rank 0 sent), over gloo on the CPU whatever the
    devices."""
    box = [cmd]
    dist.broadcast_object_list(box, src=0, device=_CPU)
    return box[0]


def _main_source() -> Optional[list]:
    """How a follower re-runs this process's main module, as
    ``multiprocessing``'s spawn does: ["name", module] under ``python -m``
    (nothing for a package's ``__main__``), ["path", file] for a script,
    ``None`` without a file (``python -c``, an interactive session)."""
    main = sys.modules["__main__"]
    name = getattr(getattr(main, "__spec__", None), "name", None)
    if name is not None:
        if name == "__main__" or name.endswith(".__main__"):
            return None
        return ["name", name]
    path = getattr(main, "__file__", None)
    return None if path is None else ["path", os.path.abspath(path)]


def reference(factory) -> tuple:
    """(module, qualified name) by which a follower imports ``factory``,
    a class, or a function or classmethod of a module-level class.
    ``ValueError`` when a follower could not: a class local to a
    function, or one in a main module that has no file."""
    module, qualname = factory.__module__, factory.__qualname__
    if "<locals>" in qualname:
        raise ValueError(
            f"{module}.{qualname} is local to a function: a mesh follower "
            "cannot import it (define it at module level)")
    if module == "__main__" and _main_source() is None:
        raise ValueError(
            f"__main__.{qualname} is defined in a main module without a "
            "file (python -c, an interactive session): a mesh follower "
            "cannot import it (define it in a file)")
    return module, qualname


def resolve(ref: Sequence[str]) -> Any:
    """The object a ``reference`` names, imported."""
    module, qualname = ref
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


class MeshGroup:
    """Rank 0's side: starts the followers and the group, builds the
    mesh, and sends the commands. ``device`` is the mesh's: "cpu", or
    "cuda" for one card a rank."""

    def __init__(self, axis_shapes: Sequence[int],
                 axis_names: Sequence[str], device):
        shape = tuple(int(s) for s in axis_shapes)
        devices = compat.rank_devices(shape, device)
        self.world = len(devices)
        self._incarnations = itertools.count(1)
        self._failure: Optional[str] = None
        self._closed = False
        # The followers' rendezvous, kept up while they live.
        self._store = dist.TCPStore(
            "127.0.0.1", 0, self.world, True,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
            wait_for_workers=False)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        argv = ["--port", str(self._store.port), "--mesh",
                ",".join(map(str, shape)), "--axes", ",".join(axis_names),
                "--device", str(device),
                "--threads", str(torch.get_num_threads()),
                "--prep", json.dumps({"sys_path": sys.path,
                                      "main": _main_source()})]
        self._procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.sharding.group",
             "--rank", str(r), *argv], env=env)
            for r in range(1, self.world)]
        try:
            self._await_followers()
            self.device = compat.start_group(self._store, 0, devices,
                                             GROUP_TIMEOUT_S)
            self.mesh = compat.make_mesh(shape, axis_names,
                                         self.device.type)
        except BaseException:
            self._kill()
            raise

    def _await_followers(self) -> None:
        """Wait until every follower has imported the port and reached
        the store, failing at once if one exits first."""
        keys = [f"ready/{r}" for r in range(1, self.world)]
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        while not self._store.check(keys):
            dead = self._dead_follower()
            if dead is not None:
                raise RuntimeError(f"{dead} before the group formed")
            if time.monotonic() > deadline:
                raise RuntimeError("mesh followers did not reach the store "
                                   f"in {GROUP_TIMEOUT_S} s")
            time.sleep(0.05)

    def _dead_follower(self) -> Optional[str]:
        for r, p in enumerate(self._procs, start=1):
            if p.poll() is not None:
                why = ""
                if self._store.check([f"failed/{r}"]):
                    why = f" ({self._store.get(f'failed/{r}').decode()})"
                return f"mesh rank {r} exited with code {p.returncode}{why}"
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

    # -- what rank 0 sends (under MESH_LOCK) ----------------------------------
    def construct(self, name: str, factory, args: Sequence = (),
                  kwargs: Optional[dict] = None) -> int:
        """Build (or rebuild, dropping the old one) object ``name`` on
        every follower as ``factory(*args, mesh=<its mesh>, **kwargs)``;
        returns the new incarnation. ``factory`` must be importable
        there (``reference``)."""
        ref = reference(factory)
        incarnation = next(self._incarnations)
        self._command(Command("construct", name, incarnation,
                              args=tuple(args), kwargs=dict(kwargs or {}),
                              factory=ref))
        return incarnation

    def call(self, name: str, incarnation: int, method: str,
             args: Sequence = (), kwargs: Optional[dict] = None) -> None:
        """Have every follower run ``method(*args, **kwargs)`` on its
        object ``name``."""
        self._command(Command("call", name, incarnation, method,
                              tuple(args), dict(kwargs or {})))

    def on_ranks(self, name: str, incarnation: int, obj, method: str,
                 args: Sequence = (), kwargs: Optional[dict] = None):
        """``getattr(obj, method)(*args, **kwargs)`` on every rank: under
        ``MESH_LOCK``, sent to object ``name`` on every follower, then run
        on ``obj`` here; returns rank 0's result. Inside another
        ``on_ranks`` of this thread it only runs here: the followers run
        the outer call, and this one with it. A failure here fails the
        group (``fail``)."""
        kwargs = dict(kwargs or {})
        with MESH_LOCK:
            if getattr(_replaying, "active", False):
                return getattr(obj, method)(*args, **kwargs)
            self.call(name, incarnation, method, args, kwargs)
            _replaying.active = True
            try:
                return getattr(obj, method)(*args, **kwargs)
            except BaseException as exc:
                self.fail(f"{name}.{method} failed on rank 0: {exc!r}")
                raise
            finally:
                _replaying.active = False

    def drop(self, name: str, incarnation: int) -> None:
        """A killed or retired object's copies go; nothing to do once the
        group has ended."""
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

def _prepare(prep: dict) -> None:
    """Rank 0's ``sys.path`` and main module, as spawn's ``prepare``."""
    sys.path[:] = prep["sys_path"]
    if prep["main"] is None:
        return
    kind, where = prep["main"]
    main = types.ModuleType("__mp_main__")
    main.__dict__.update(
        runpy.run_module(where, run_name="__mp_main__", alter_sys=True)
        if kind == "name" else runpy.run_path(where,
                                              run_name="__mp_main__"))
    sys.modules["__main__"] = sys.modules["__mp_main__"] = main


def _serve_commands(rank: int, mesh, device) -> None:
    """Run rank 0's commands on this follower's objects until "exit"."""
    objects: dict[str, tuple[int, Any]] = {}
    while True:
        cmd = _send(None)
        if cmd.op == "exit":
            # "learners": the training program's name for the objects.
            print(json.dumps({"mesh_rank": rank, "device": str(device),
                              "learners": {
                                  name: {"incarnation": inc,
                                         **(obj.mirror_state()
                                            if hasattr(obj, "mirror_state")
                                            else {})}
                                  for name, (inc, obj) in objects.items()}}),
                  flush=True)
            return
        if cmd.op == "construct":
            objects.pop(cmd.name, None)     # free the old shards first
            objects[cmd.name] = (cmd.incarnation, resolve(cmd.factory)(
                *cmd.args, mesh=mesh, **cmd.kwargs))
        elif cmd.op == "drop":
            objects.pop(cmd.name, None)
        elif cmd.op == "call":
            inc, obj = objects.get(cmd.name, (None, None))
            if inc != cmd.incarnation:
                raise RuntimeError(
                    f"rank {rank}: {cmd.method} for {cmd.name} incarnation "
                    f"{cmd.incarnation}, which it does not hold")
            getattr(obj, cmd.method)(*cmd.args, **cmd.kwargs)
        else:
            raise RuntimeError(f"rank {rank}: unknown command {cmd.op}")


def follow(argv=None) -> int:
    """A follower's life: join the group, build the mesh, then run rank
    0's commands until "exit". A command that fails leaves its exception
    in the store for rank 0's error message."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--axes", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--threads", type=int, required=True)
    ap.add_argument("--prep", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    _prepare(json.loads(args.prep))
    from repro_torch.core.nodes.base import (WorkerContext,
                                             set_current_context)

    shape = tuple(int(s) for s in args.mesh.split(","))
    devices = compat.rank_devices(shape, args.device)
    store = dist.TCPStore(
        "127.0.0.1", args.port, len(devices), False,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    store.set(f"ready/{args.rank}", "1")
    device = compat.start_group(store, args.rank, devices, GROUP_TIMEOUT_S)
    mesh = compat.make_mesh(shape, args.axes.split(","), device.type)
    # No courier, stop event or endpoint of the program's here.
    set_current_context(WorkerContext(node_name=f"mesh rank {args.rank}"))
    try:
        _serve_commands(args.rank, mesh, device)
    except BaseException as exc:
        store.set(f"failed/{args.rank}", repr(exc)[:2000])
        raise
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    # The module's own copy (not this ``__main__`` one) holds MESH_LOCK.
    from repro_torch.sharding.group import follow as _follow
    sys.exit(_follow())
