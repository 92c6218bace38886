"""Probes of the card: the FP32 throughput probe (``vpu_peak``) and the
flat pair kernel's cost probe (``probe_kernel``), ports of the
reference's ``tools/vpu_peak.py`` and ``tools/probe_kernel.py``."""
