"""The on-chip benchmark of ``repro_torch``, the PyTorch and CUDA port of
SO2DR (arXiv:2309.08864).

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json``, the
plain reference of the configuration's stencil in
``references/<reference>.py``, the limits of its correctness check in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.  The yardstick (the reference, the kernel
bound's counts and peaks, the trace reduction, the comparison) lives
here; from the program the benchmark takes only the entry it times and
the program's counters and kernel names.
"""
