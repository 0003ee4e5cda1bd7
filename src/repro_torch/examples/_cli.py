"""The examples' shared ``--device`` flag."""

from __future__ import annotations

import argparse


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; needs a card) or cpu")
    return ap


def checked_device(name: str):
    """``name`` as a torch device; "cuda" raises without a card (no
    example falls back to the CPU)."""
    from repro_torch.serve.engine import resolve_device
    return resolve_device(name)
