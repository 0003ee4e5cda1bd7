"""The port's framework-free modules are copies of the JAX package's.

After the rename ``repro.`` -> ``repro_torch.``, every file under
``src/repro_torch/core/``, the serve fabric's ``router.py`` and
``rollout.py`` and the data pipeline must equal its twin under
``src/repro/`` — except the core files that carry the port's three
edits (lazy ``grpc``/``cloudpickle`` imports, tensor serialization,
``MeshWorkerNode``'s torch device). The trees are read as text; neither
package is imported.
"""

import os
import re

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
REF, PORT = os.path.join(SRC, "repro"), os.path.join(SRC, "repro_torch")

# The core files the port edits on purpose (ROADMAP.md, north star).
EDITED = {"courier/serialization.py", "courier/server.py",
          "courier/transport.py", "launchers/process.py", "nodes/mesh.py"}


def _py_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".py"))


def _renamed(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.",
                  text.replace("from repro import", "from repro_torch import"))


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


CORE = _py_files(os.path.join(REF, "core"))
COPIES = ([f"core/{f}" for f in CORE if f not in EDITED]
          + ["serve/router.py", "serve/rollout.py", "data/pipeline.py"])


def test_core_file_sets_match():
    assert _py_files(os.path.join(PORT, "core")) == CORE
    assert EDITED <= set(CORE)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference_after_rename(rel):
    want = _renamed(_read(os.path.join(REF, rel)))
    got = _read(os.path.join(PORT, rel))
    assert got == want, (f"src/repro_torch/{rel} drifted from "
                         f"src/repro/{rel}")


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_edited_core_files_really_differ(rel):
    """The named exceptions stay exceptions: a file that no longer needs
    its edit belongs in the copy check."""
    assert (_read(os.path.join(PORT, "core", rel))
            != _renamed(_read(os.path.join(REF, "core", rel))))
