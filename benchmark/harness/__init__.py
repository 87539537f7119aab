"""The benchmark harness of qinfer_tpu_torch: one run of one cell.

``registry`` finds a cell's configuration, traffic, driver and per-layer
metrics by the names in ``BENCHMARK.json``; ``window`` runs a driver's
units for the measured window; ``trace`` reduces a profiler trace to the
numbers the metric readers take; ``runner`` ties them into the result
line. Nothing here imports JAX or the JAX package; the port is imported
only inside the functions that run it.
"""
