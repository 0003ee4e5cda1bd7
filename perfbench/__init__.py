"""The benchmark of ``repro_torch`` on one NVIDIA H100: a data-driven
harness. ``run.py`` is its one command; ``README.md`` says how to add an
architecture, a configuration, a traffic mix, a metric or a cell as new
files."""
