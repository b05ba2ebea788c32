"""Per-layer metric readers, one module per metric, named as the metric.

Each exposes ``read(ctx)``: the metric's value from the run's
:class:`so2dr_bench.harness.Context`, or None when the run holds nothing
for it to read (the harness then leaves the metric out of the line).
"""
