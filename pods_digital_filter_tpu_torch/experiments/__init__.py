"""The TPU kernel experiments of ``benchmarks/exp_*.py``, ported: each
entry point runs the original's variants with the port's kernels and prints
the original's table in ms per repetition, measured on the card.

    python -m pods_digital_filter_tpu_torch.experiments.two_kernel_pipeline
    python -m pods_digital_filter_tpu_torch.experiments.pipelined_kernel

They read the originals' environment variables (``EXP_NF``, ``EXP_SIZES``,
``EXP_VARIANTS``, ``EXP_TEMPORAL``) with the same defaults, and run on the
card only.
"""
