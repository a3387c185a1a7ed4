"""The port's ``parallel/`` — so far :mod:`.time_ops`, which runs on one
device; the sharded modules of ``pods_digital_filter_tpu/parallel/`` are
slice 5 of the port (ROADMAP.md, queue A item 11)."""
