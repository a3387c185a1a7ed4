"""``work.py``'s counts against shapes worked by hand."""

from h100bench import work


def test_k1_bytes_main_size():
    # 3 components x (1,024 + 16) slabs x 512 x 512 float32 outputs
    assert work.k1_bytes(1040, 512, 512) == 3 * 1040 * 512 * 512 * 4
    assert work.k1_bytes(1040, 512, 512) == 3_271_557_120
    ms, by = work.k1_bound_ms(1040, 512, 512, 8)
    assert by == "bytes"
    assert abs(ms - 3_271_557_120 / 3.35e12 * 1e3) < 1e-12


def test_filter_work_by_hand():
    # 17 taps; z pass over (528 x 512) and y pass over (512 x 512) per slab
    jn, taps = 528, 17
    assert work.filter_work(1040, 512, 512, 8) == \
        3 * 2 * taps * ((jn * 512 + 512 * 512) * 1040)


def test_gram_flops_lower_triangle_flagship():
    np3, ns, block = 3 * 1024 * 512, 10240, 512
    nb = 20
    tiles = nb * (nb + 1) // 2            # 210 tiles on and below the diagonal
    assert tiles == 210
    want = 2.0 * np3 * block * block * tiles
    assert work.gram_flops(np3, ns, block) == want
    assert abs(want - 1.7317e14) / want < 1e-3
    # a ragged last block
    assert work.gram_flops(10, 5, 2) == 2.0 * 10 * (4 + 4 + 4 + 2 + 2 + 1)


def test_generations_flagship():
    # mean pass 20, Gram pass 20 + 12 + 4 = 36, projection 20
    assert work.generations(10240, 512, 8) == 76
    assert work.generations(1024, 256, 2) == 14


def test_replay_bytes_flagship():
    n = 3 * 1024 * 512
    b = work.replay_bytes(1024 * 512, 3, 20, 9, 16)
    assert b == 8 * (20 * n + n + 16 * n + 3 * 20 * 9)
    # modes 252 MB, mean 13 MB, output 201 MB
    assert abs(b - 0.4656e9) / b < 1e-3


def test_bound_picks_the_larger():
    assert work.bound(3.35e12)[1] == "bytes"
    assert work.bound(1.0, 67e12)[1] == "operations"
    assert abs(work.bound(0, 67e12)[0] - 1e3) < 1e-9
