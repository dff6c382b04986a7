"""A cell on several cards: one process per card on this host, the
harness's own messages on a gloo side group, and the result's ``device``
merged from every card's report.

``run.py`` is rank 0, on the first device.  It builds or loads the
program's kernels there first and only then starts ranks 1..K-1, the same
command with ``--rank r``, each on device r, so that no two processes
build into one ``build/`` directory.  Every rank joins the program's group
through ``multihost.initialize_multihost`` from the port's launcher
variables (``DDPS_COORDINATOR`` on a free port of this host,
``DDPS_NUM_PROCESSES``, ``DDPS_PROCESS_ID``), as the CLI does, and then a
gloo group of the harness's own (:class:`SideGroup`), so that none of the
harness's messages runs on the program's NCCL stream.  Every rank then
runs :func:`harness.run_cell` in step: the same set-up, warm-up and
seeded requests.  Rank 0 alone keeps the records, decides when the window
has ended and tells the others after each answer; after the window every
rank frees its card and sends rank 0 its report, and rank 0 judges and
prints.

Failure never falls back to fewer cards.  A follower that ends with an
error, or is killed, ends the run at once: rank 0 kills the others and
exits with :data:`EXIT_RANK_LOST`, printing no result.  An error in rank 0
kills the followers and exits 1.  A rank that waits longer than
:data:`TIMEOUT_S` for another raises (gloo) or is aborted (NCCL), and a
follower whose rank 0 has gone exits.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from typing import List, Optional

from . import harness

# Longest a rank waits for a message of another, in the program's group
# and in the side group; also how long rank 0 waits for its followers to
# end once the reports are in.
TIMEOUT_S = 180.0
POLL_S = 0.2  # how often rank 0 looks at its followers, a follower at rank 0
EXIT_RANK_LOST = 4


def free_port() -> int:
    """A port of this host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class SideGroup:
    """The harness's messages between the ranks, on a gloo group of their
    own: the end of the window and the reports.  ``answers`` counts the
    window's answers, one per :meth:`ended`."""

    def __init__(self, pg, rank: int, world: int):
        self.pg = pg
        self.rank = rank
        self.world = world
        self.answers = 0

    @classmethod
    def join(cls, device) -> "SideGroup":
        """Join the program's group from the launcher variables, then the
        side group; every rank calls this."""
        import torch.distributed as dist

        from domain_decomposed_pde_solver_tpu_torch.parallel.multihost import (
            initialize_multihost,
        )

        initialize_multihost(device=str(device), timeout_s=TIMEOUT_S)
        pg = dist.new_group(backend="gloo",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        return cls(pg, dist.get_rank(), dist.get_world_size())

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.pg)

    def ended(self, ended: bool) -> bool:
        """Rank 0's ``ended``, on every rank."""
        import torch
        import torch.distributed as dist

        flag = torch.tensor([int(ended)])
        dist.broadcast(flag, src=0, group=self.pg)
        self.answers += 1
        return bool(flag.item())

    def finish(self, report: dict) -> Optional[List[dict]]:
        """Send this rank's report to rank 0 and leave both groups; every
        rank calls this once its card is freed, so rank 0's return is the
        barrier after which no rank holds program state.  Rank 0 gets every
        rank's report, in rank order, once each rank has loaded no
        forbidden module and answered as many requests as rank 0; the
        others get None."""
        import torch.distributed as dist

        sent = dict(report, answers=self.answers,
                    forbidden=harness.forbidden_modules())
        got = [None] * self.world if self.rank == 0 else None
        dist.gather_object(sent, got, dst=0, group=self.pg)
        dist.destroy_process_group()
        if self.rank:
            return None
        answers = [r.pop("answers") for r in got]
        harness.log(f"answers per rank: {answers}")
        found = {m for r in got for m in r.pop("forbidden")}
        if found:
            raise RuntimeError(f"a rank loaded modules that the benchmark "
                               f"may not load: {', '.join(sorted(found))}")
        if len(set(answers)) != 1:
            raise RuntimeError(f"the ranks answered {answers} requests")
        return got


class Followers:
    """Ranks 1..K-1 as child processes of rank 0, each ``command`` with
    ``--rank r``, watched from a thread: one that ends with an error or is
    killed ends this process at once, the others killed first."""

    def __init__(self, command: List[str], world: int, env: dict):
        self.procs = []
        for r in range(1, world):
            p = subprocess.Popen(
                [*command, "--rank", str(r)],
                env=dict(env, DDPS_PROCESS_ID=str(r)),
                stdout=sys.stderr.fileno())
            harness.log(f"started rank {r} (pid {p.pid})")
            self.procs.append(p)
        self.stop = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self.stop.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc not in (None, 0):
                    harness.log(f"rank {r} ended with code {rc} inside the "
                                f"run: the run ends, on no fewer cards")
                    self.kill()
                    sys.stderr.flush()
                    os._exit(EXIT_RANK_LOST)

    def wait(self, timeout: float) -> None:
        """Wait for every follower to end; raises (the rest killed) if one
        ends with an error or does not end within ``timeout``."""
        self.stop.set()
        deadline = time.monotonic() + timeout
        for r, p in enumerate(self.procs, 1):
            try:
                rc = p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                self.kill()
                raise RuntimeError(
                    f"rank {r} ended with code {rc}" if rc is not None else
                    f"rank {r} did not end within {timeout:.0f} s")

    def kill(self) -> None:
        self.stop.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


def _leave_with_parent() -> None:
    """End this process once the process that started it has gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(POLL_S)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _fail(code: int) -> None:
    traceback.print_exc()
    sys.stderr.flush()
    os._exit(code)


def lead(cell, seed: int, seconds: float, trace: bool, devices: List[str],
         t_start: float, root, command: List[str]) -> dict:
    """Rank 0 of a run of ``cell`` over ``devices``, one process each;
    ``command`` starts a follower once ``--rank r`` is added.  Returns the
    result's line; on any failure ends this process with no result."""
    world = len(devices)
    device = harness.open_device(devices[0])
    launch = {"DDPS_COORDINATOR": f"localhost:{free_port()}",
              "DDPS_NUM_PROCESSES": str(world)}
    os.environ.update(launch, DDPS_PROCESS_ID="0")
    followers = Followers(command, world, dict(os.environ, **launch))
    try:
        side = SideGroup.join(device)
        result = harness.run_cell(cell, seed, seconds, trace, device,
                                  t_start, root, side=side)
        followers.wait(TIMEOUT_S)
    except BaseException:
        followers.kill()
        _fail(1)
    return result


def follow(cell, seed: int, seconds: float, trace: bool, devices: List[str],
           rank: int, t_start: float, root) -> int:
    """Rank ``rank`` of a run that rank 0 leads, on ``devices[rank]``;
    returns 0, or ends this process with code 1 on any failure."""
    _leave_with_parent()
    try:
        side = SideGroup.join(devices[rank])
        harness.run_cell(cell, seed, seconds, trace, devices[rank], t_start,
                         root, side=side)
    except BaseException:
        _fail(1)
    return 0
