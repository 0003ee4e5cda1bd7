"""The yardstick's peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense
rates at the full 700 W (``roofline/analysis.py`` of the port holds the
same constants). One set for every architecture; the operations and
bytes that the work needs are counted by the architecture's module
(``archs/<name>.py``)."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
