"""A cell over several cards: one process (rank) per card, joined in one
``torch.distributed`` job through the program's own
``parallel.mesh.init_distributed``.

The process that ``run.py`` started is rank 0.  ``Job.start`` starts ranks
``1 .. N-1`` as processes of their own, running ``run.py`` on the same cell,
seed, seconds and trace flag with ``--rank r --job <dir>``; ``<dir>`` holds
the job's ``file://`` store, ``job.json`` (the world size, the device and
rank 0's pid) and one log per rank, which takes that rank's standard output
and error, so that the last line of standard output is always rank 0's.
Every rank joins before its first CUDA call; the program's ``make_mesh``
then chooses each rank's card and the backend (NCCL when every rank has a
card of its own, else gloo), as for ``--multihost``.

A job never hangs and never leaves a card held:

* rank 0 watches the other ranks from a thread: a rank that exits with a
  code other than 0, or a job still running ``--seconds`` plus the
  program's collective timeout (``parallel.mesh.TIMEOUT_S``) after it
  started, ends the job: every other rank is killed, the failing rank's
  last lines are printed on standard error and rank 0 exits with code 5,
  printing no result;
* rank 0 raising before the job closed ends it the same way;
* the other ranks ask the kernel for ``SIGKILL`` when rank 0 dies
  (``PR_SET_PDEATHSIG``).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback

#: the lines of a rank's log that rank 0 prints on standard error
TAIL_LINES = 20
#: rank 0's exit code when the watchdog ends the job
ENDED = 5


def _tail(path, lines=TAIL_LINES):
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - 16384))
            text = f.read().decode("utf-8", "replace")
    except OSError:
        return []
    return text.splitlines()[-lines:]


def _die_with_parent():
    """SIGKILL to this process when the thread that started it ends."""
    libc = ctypes.CDLL(None, use_errno=True)
    PR_SET_PDEATHSIG = 1
    if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")


class Job:
    """This process's rank in a job of ``world`` ranks: the collectives the
    harness and the entries need, on the job's default (gloo) group."""

    def __init__(self, rank, world, path, device, procs=(), budget=None,
                 cleanup=()):
        self.rank, self.world, self.dir, self.device = rank, world, path, \
            device
        self.procs = list(procs)            # rank 0: ranks 1 .. N-1
        self.budget = budget                # rank 0: seconds the job may run
        self.deadline = None if budget is None else time.monotonic() + budget
        self.cleanup = list(cleanup)        # rank 0: removed if the job ends
        self._lock = threading.Lock()
        self._over = False
        self._done = threading.Event()
        self._watch = None

    # --- starting and joining ---------------------------------------------

    @classmethod
    def start(cls, root, argv, world, device, seconds, cleanup=()):
        """Rank 0: start ranks ``1 .. world-1`` running ``run.py argv`` in
        ``root``, watch them, and join the job."""
        from pods_digital_filter_tpu_torch.parallel import mesh

        path = tempfile.mkdtemp(prefix="h100bench-job-")
        with open(os.path.join(path, "job.json"), "w") as f:
            json.dump({"world": world, "device": device,
                       "parent": os.getpid()}, f)
        run_py = os.path.join(root, "h100bench", "run.py")
        procs = []
        try:
            for r in range(1, world):
                with open(os.path.join(path, f"rank{r}.log"), "wb") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, run_py, *argv, "--rank", str(r),
                         "--job", path],
                        stdin=subprocess.DEVNULL, stdout=log,
                        stderr=subprocess.STDOUT, cwd=root))
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            shutil.rmtree(path, ignore_errors=True)
            raise
        job = cls(0, world, path, device, procs, seconds + mesh.TIMEOUT_S,
                  cleanup)
        job._watch = threading.Thread(target=job._watchdog, daemon=True,
                                      name="h100bench-job-watchdog")
        job._watch.start()
        try:
            job._init()
        except BaseException:
            traceback.print_exc()
            job.fail("rank 0 could not join")
        return job

    @classmethod
    def join(cls, rank, path):
        """Rank ``rank`` > 0: die with rank 0, then join its job."""
        _die_with_parent()
        with open(os.path.join(path, "job.json")) as f:
            info = json.load(f)
        if os.getppid() != info["parent"]:
            raise RuntimeError("rank 0 ended before this rank started")
        job = cls(rank, int(info["world"]), path, info["device"])
        job._init()
        return job

    def _init(self):
        from pods_digital_filter_tpu_torch.parallel import mesh

        mesh.init_distributed(
            init_method="file://" + os.path.join(self.dir, "store"),
            num_processes=self.world, process_id=self.rank)

    # --- collectives --------------------------------------------------------

    def decide(self, value):
        """Rank 0's ``value`` on every rank."""
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self):
        import torch.distributed as dist

        dist.barrier()

    def gather(self, obj):
        """Every rank's ``obj``, in rank order, on every rank."""
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def close(self):
        """Leave the job once every rank is here; rank 0 then waits until
        every other rank has ended with code 0 and prints their last
        lines."""
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
        if self.rank:
            return
        self._done.wait()
        self._watch.join()
        for r, p in enumerate(self.procs, 1):
            for line in _tail(self._log(r)):
                print(f"rank {r}| {line}", file=sys.stderr)
        shutil.rmtree(self.dir, ignore_errors=True)

    # --- ending -------------------------------------------------------------

    def _log(self, r):
        return os.path.join(self.dir, f"rank{r}.log")

    def _watchdog(self):
        while True:
            codes = [p.poll() for p in self.procs]
            if all(c == 0 for c in codes):
                self._done.set()
                return
            failed = [(r, c) for r, c in enumerate(codes, 1)
                      if c not in (None, 0)]
            if failed:
                r, c = failed[0]
                why = f"rank {r} exited with code {c}"
            elif time.monotonic() > self.deadline:
                why = (f"still running {self.budget:g} s after it started "
                       f"(--seconds plus the collective timeout)")
            else:
                time.sleep(0.1)
                continue
            self.fail(why)
            return

    def end(self, why):
        """Rank 0: kill every other rank, wait for each, print the last
        lines of those that failed (of all where none did), remove the
        job's directory.  Once only; False where the job had ended."""
        with self._lock:
            if self._over or self.rank:
                return False
            self._over = True
        codes = [p.poll() for p in self.procs]
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        print(f"refused: job of {self.world} ranks ended: {why}",
              file=sys.stderr)
        failed = [r for r, c in enumerate(codes, 1) if c not in (None, 0)]
        for r in failed or range(1, self.world):
            print(f"rank {r} (exit code {codes[r - 1]}), its last lines:",
                  file=sys.stderr)
            for line in _tail(self._log(r)):
                print(f"rank {r}| {line}", file=sys.stderr)
        shutil.rmtree(self.dir, ignore_errors=True)
        return True

    @property
    def closed(self):
        """Every rank left the job normally (rank 0)."""
        return self._done.is_set()

    def fail(self, why):
        """Rank 0: end the job and exit with ``ENDED`` at once, printing no
        result: a process group whose peers are gone can hold the
        interpreter's exit for the collective timeout.  Returns only in the
        watchdog, where the main thread is ending the job."""
        if self.end(why):
            for d in self.cleanup:
                shutil.rmtree(d, ignore_errors=True)
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(ENDED)
        if threading.current_thread() is not self._watch:
            self._watch.join()
            os._exit(ENDED)
