"""The plain references: each architecture's mathematics in float32
PyTorch, one module an architecture (``transformer.py``), on what
``common.py`` holds for all of them. None imports ``repro_torch`` or
JAX; an architecture's module (``archs/<name>.py``) names its own."""
