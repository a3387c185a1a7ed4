"""Times K1 and K4 at the main path's shape (512 x 512, nf 8, 1,040 slabs x
3; K4 1,024 steps, f32 taps) with every strip step and tile their wrappers
could pick, and a few they do not, so that the choice in
``fused_filter.WALK_TILES`` and ``fused_temporal.TEMPORAL_TILES`` rests on
a measurement:

    python3 -m pods_digital_filter_tpu_torch.experiments.tile_trial

Device time by CUDA events over 3 launches after a warm-up; on the card
only.  It checks nothing (chip_smoke.py holds the kernels to their plain
versions).
"""

import torch

from pods_digital_filter_tpu_torch.experiments._timing import device
from pods_digital_filter_tpu_torch.ops import (_build, filters, fused_filter,
                                               fused_temporal, philox)

K1_STEPS = ((128, 32), (128, 16), (64, 32), (128, 64))
K4_TILES = ((32, 32), (32, 16), (64, 32), (64, 16))


def _ms(launch, reps=3):
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    dev = device()
    lib, _ = _build.load()
    b = filters.gaussian_fir_coeffs(8, 4.0, torch.float32, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((3, 1040, 512, 512), device=dev)
    for bf16 in (0, 1):
        for ks, ch in K1_STEPS:
            def k1():
                _build.check_launch(lib.fused_filter_launch(
                    fused_filter._PHILOX_FILTERED, bf16, 0, None,
                    out.data_ptr(), None, b.data_ptr(), b.data_ptr(), 8, 8,
                    512, 512, 3, 1040, ks, ch, 0, 1, 2, philox.SCALE, 1.0,
                    stream, None), "K1")
            print(f"tile_trial K1 {'bf16' if bf16 else 'f32'} taps, "
                  f"{ks} x {ch} step: {_ms(k1):.3f} ms", flush=True)
    del out
    y = torch.empty((3, 1024, 512, 512), device=dev)
    for ks, ch in K4_TILES:
        slots = lib.fused_temporal_slots(8, 8, 8, ks, ch, 0, 0,
                                         torch.cuda.current_device())
        chunk = fused_temporal._chunk(
            1024, 8, -(-512 // ch) * -(-512 // ks) * 3, slots)

        def k4():
            _build.check_launch(lib.fused_temporal_launch(
                0, None, y.data_ptr(), b.data_ptr(), b.data_ptr(),
                b.data_ptr(), 8, 8, 8, 512, 512, 3, 1024, chunk, ks, ch, 0,
                1, 2, philox.SCALE, stream), "K4")
        print(f"tile_trial K4 {ch} x {ks} tile ({slots} block slots, chunk "
              f"{chunk}): {_ms(k4):.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
