"""Process supervisor: relaunch-on-failure around resumable workers (twin
of ``stepth_tpu/utils/supervisor.py``, which holds no JAX; the port keeps
its own copy because importing the JAX package imports JAX).

The recovery model is fail-fast + restart-from-checkpoint: a worker that
dies is relaunched by this supervisor and resumes from its checkpoint
(:func:`stepth_tpu_torch.fusion.resumable.solve_resumable`).

The worker is a real OS process — the failure domain being defended against
is process death (preemption, fail-fast abort, OOM kill), which cannot be
caught in-process. ``argv`` may be a callable of the attempt number so a
restart can change topology — e.g. relaunch single-process on the surviving
host after a peer is lost ("shrunken mesh": the worker rebuilds its mesh from
the devices it sees via ``stepth_tpu_torch.fusion.resumable.auto_mesh``).
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Union

Argv = Union[List[str], Callable[[int], List[str]]]


def supervise(
    argv: Argv,
    max_restarts: int = 3,
    backoff_s: float = 0.5,
    env: Optional[Dict[str, str]] = None,
    attempt_timeout_s: Optional[float] = None,
    log: Callable[[str], None] = lambda m: print(m, file=sys.stderr),
) -> int:
    """Run ``argv`` until it exits 0, relaunching on any failure.

    * ``argv`` — the worker command, or a callable ``attempt -> command``
      (attempt 0 is the first launch) for restarts that change topology.
    * ``max_restarts`` — relaunches after the first attempt; exceeded ⇒ the
      last exit code is returned (never raises).
    * ``backoff_s`` — sleep before each relaunch, doubling per attempt.
    * ``attempt_timeout_s`` — per-attempt wall-clock bound; a hung worker is
      killed and counts as a failure (rc −9).

    Returns the final exit code (0 on success). The worker must be resumable
    — persist progress and continue when rerun — or restarts repeat work.
    """
    attempt = 0
    while True:
        cmd = argv(attempt) if callable(argv) else argv
        try:
            rc = subprocess.run(cmd, env=env, timeout=attempt_timeout_s).returncode
        except subprocess.TimeoutExpired:
            rc = -9
            log(f"[supervisor] attempt {attempt} hung past "
                f"{attempt_timeout_s}s and was killed")
        if rc == 0:
            if attempt:
                log(f"[supervisor] recovered after {attempt} restart(s)")
            return 0
        if attempt >= max_restarts:
            log(f"[supervisor] giving up: rc={rc} after {attempt} restart(s)")
            return rc
        delay = backoff_s * (2.0 ** attempt)
        log(f"[supervisor] worker rc={rc}; restart "
            f"{attempt + 1}/{max_restarts} in {delay:.1f}s")
        time.sleep(delay)
        attempt += 1
