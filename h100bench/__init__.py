"""The H100 benchmark of ``pods_digital_filter_tpu_torch``: ``run.py`` runs
one cell of ``BENCHMARK.json`` once."""
