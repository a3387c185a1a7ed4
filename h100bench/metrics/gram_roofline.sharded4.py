"""``gram_roofline.sharded4``: rank 0's share of the f32 peak in the
sharded Gram, in %: a rank's share of the FLOPs the symmetric Gram needs
(``mesh_work.py``, counted from shapes: its distinct entries, over the
ranks) times the window's models, over the traced time of rank 0's
kernels whose name holds ``gemm`` inside the program's ``pod.gram`` spans,
at 67 TFLOP/s.  The count is the work needed, not the work executed: a
Gram that forms each rank's whole strip executes about twice it, so one
that uses the symmetry reads higher on the same count.  Rank 0 holds an
even share of the ranks' work, so the share cannot pass 100 %; None where
no such span or kernel was traced."""

from h100bench import mesh_work, work


def read(run):
    if run.trace is None or run.cell.entry != "pipeline" or not run.units:
        return None
    sec, _ = run.trace.kernel_seconds(
        lambda name: "gemm" in name.lower() and "gemv" not in name.lower(),
        stages=("pod.gram",))
    if sec <= 0:
        return None
    flops = mesh_work.gram_flops_rank(run.cell.config["sizes"]) * len(
        run.units)
    return 100.0 * flops / sec / work.PEAK["f32"]
