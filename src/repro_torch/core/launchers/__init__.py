from repro_torch.core.launchers.base import Launcher
from repro_torch.core.launchers.dryrun import DryRunLauncher, DryRunReport
from repro_torch.core.launchers.process import ProcessLauncher
from repro_torch.core.launchers.test import ProgramTestError, launch_and_wait
from repro_torch.core.launchers.thread import ThreadLauncher

__all__ = [
    "Launcher", "ThreadLauncher", "ProcessLauncher", "DryRunLauncher",
    "DryRunReport", "launch_and_wait", "ProgramTestError",
]
