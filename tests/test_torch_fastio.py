"""The port's ``.prf`` table writer (``native/fastio.c``
``write_rows_fixed12``) on tables large enough that it formats them on
several threads: its bytes are Python's ``"%0.12f"`` rows and the JAX
package's writer's, one thread or many, and two callers at once each get
their own table."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from pods_digital_filter_tpu import native as jnative
from pods_digital_filter_tpu_torch import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: values that leave the integer formatter (``snprintf``), or sit at its
#: edges
SPECIAL = [1e12, -1e12, np.inf, -np.inf, np.nan, -0.0, 1e-13, -1e-13,
           8.0e6, -8.0e6, 8000000.5, 0.0, 1.0000000000005, 3.999999999999]


#: a prime row count over 270,000 values a table: past the writer's
#: threshold of 256 Ki values, and no count of parts divides it, so the
#: last part is short (the writer cuts a table into 8 parts a thread)
ROWS = {1: 270001, 2: 135007, 3: 90001, 6: 45007}


def _table(ncols, seed=0):
    """Magnitudes from 1e-9 to 1e6, the special values in the first, a
    middle and the last part."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((ROWS[ncols], ncols)) * 10.0 ** rng.integers(
        -9, 7, (ROWS[ncols], 1))
    flat = t.reshape(-1)
    for start in (0, flat.size // 2, flat.size - len(SPECIAL)):
        flat[start:start + len(SPECIAL)] = SPECIAL
    return t


def _python_rows(rows):
    return "".join(",".join("%0.12f" % v for v in r) + "\n"
                   for r in rows).encode()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", ["w", "a"])
@pytest.mark.parametrize("ncols", [1, 2, 3, 6])
def test_parallel_rows_are_python_and_jax_bytes(tmp_path, ncols, mode):
    rows = _table(ncols, seed=ncols)
    # "a" keeps a header line, "w" truncates what was there
    before = b"# header\n" if mode == "a" else b"stale " * 1000
    want = (before if mode == "a" else b"") + _python_rows(rows)
    for side, mod in (("torch", tnative), ("jax", jnative)):
        path = str(tmp_path / f"{side}.prf")
        with open(path, "wb") as f:
            f.write(before)
        assert mod.write_rows_fixed12(path, mode, rows)
        assert _read(path) == want, side


def test_one_thread_gives_the_same_bytes(tmp_path):
    """The same table from a process held to one processor with
    ``OMP_NUM_THREADS=1``, which formats it on one thread."""
    rows = _table(6, seed=7)
    np.save(tmp_path / "rows.npy", rows)
    many = str(tmp_path / "many.prf")
    assert tnative.write_rows_fixed12(many, "w", rows)
    threads = tnative._load().write_rows_fixed12_threads()
    if len(os.sched_getaffinity(0)) >= 3:
        assert threads > 1
    code = (
        "import os, sys\n"
        "os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})\n"
        "import numpy as np\n"
        "from pods_digital_filter_tpu_torch import native\n"
        "assert native.write_rows_fixed12(sys.argv[2], 'w', "
        "np.load(sys.argv[1]))\n"
        "print(native._load().write_rows_fixed12_threads())\n")
    one = str(tmp_path / "one.prf")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "rows.npy"), one],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "1"
    assert _read(one) == _read(many) == _python_rows(rows)


def test_two_callers_at_once_keep_their_rows(tmp_path):
    """Two Python threads write two different large tables at the same
    time, many times: each file holds its own table's rows."""
    tables = [_table(6, seed=11), _table(3, seed=12)]
    want = [_python_rows(t) for t in tables]
    start = threading.Barrier(2, timeout=60)
    bad, done = [[], []], [0, 0]

    def work(i):
        path = str(tmp_path / f"caller{i}.prf")
        start.wait()
        for k in range(12):
            assert tnative.write_rows_fixed12(path, "w", tables[i])
            if _read(path) != want[i]:
                bad[i].append(k)
            done[i] += 1

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert done == [12, 12] and bad == [[], []]


@pytest.mark.skipif(not os.path.exists("/dev/full"), reason="no /dev/full")
@pytest.mark.parametrize("ncols", [1, 6])
def test_a_failed_write_raises(ncols):
    """A device that takes no bytes: the writer stops its threads and the
    wrapper raises, for a small table and a large one."""
    for rows in (_table(ncols)[:2], _table(ncols)):
        with pytest.raises(OSError):
            tnative.write_rows_fixed12("/dev/full", "w", rows)
