"""TestLauncher: launch and wait for termination (paper §3.2).

"Optionally, the launcher can wait for or monitor the individual nodes
after they begin execution. This is especially useful in integration tests
... in which we want to verify that the distributed system performs a task
and terminates correctly."
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.core.fault import RestartPolicy
from repro_torch.core.launchers.thread import ThreadLauncher
from repro_torch.core.program import Program


class ProgramTestError(AssertionError):
    pass


def launch_and_wait(program: Program,
                    resources: Optional[dict[str, dict[str, Any]]] = None,
                    timeout_s: float = 30.0,
                    restart_policy: Optional[RestartPolicy] = None,
                    force_grpc: bool = False) -> ThreadLauncher:
    """Run a program to completion in-process; raise on failure/timeout."""
    launcher = ThreadLauncher(
        force_grpc=force_grpc,
        restart_policy=restart_policy or RestartPolicy(max_restarts=0))
    launcher.launch(program, resources)
    finished = launcher.wait(timeout=timeout_s)
    if launcher.fatal_failures:
        f = launcher.fatal_failures[0]
        raise ProgramTestError(
            f"program {program.name!r}: node {f.node_name} failed fatally"
        ) from f.error
    if not finished:
        launcher.stop()
        launcher.wait(timeout=5.0)
        raise ProgramTestError(
            f"program {program.name!r} did not terminate within {timeout_s}s")
    return launcher
