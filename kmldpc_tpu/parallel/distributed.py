"""Multi-host wiring: ``jax.distributed`` initialization + process roles.

The reference is a single process (SURVEY.md §2: shared-memory threading
only).  Scaling beyond one host here follows the standard JAX recipe: one
process per host, ``jax.distributed.initialize()`` (coordinator address
from the environment), a mesh spanning ``jax.devices()`` (all devices of
all hosts), and the existing shard_map chunk
with psum'd counters.  Because counters come back replicated, every process
applies identical stopping rules in lockstep — no extra control-plane
communication is needed.

Environment contract (standard JAX variables):
  JAX_COORDINATOR_ADDRESS (or COORDINATOR_ADDRESS)  host:port of process 0
  JAX_NUM_PROCESSES / JAX_PROCESS_ID                process count and rank
With neither the address nor the process count set, the run is
single-process.
"""

from __future__ import annotations

import os


def maybe_initialize() -> bool:
    """Initialize jax.distributed when a coordinator is configured.

    Returns True when running multi-process.  Safe to call repeatedly.
    """
    import jax

    coord = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    num = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if coord is None and num is None:
        return False
    try:
        kwargs = {}
        if coord:
            kwargs["coordinator_address"] = coord
        if num:
            kwargs["num_processes"] = int(num)
        if pid:
            kwargs["process_id"] = int(pid)
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        # already initialized
        pass
    return jax.process_count() > 1


def is_primary() -> bool:
    import jax

    return jax.process_index() == 0
