"""Multi-process (multi-host) bootstrap.

JAX equivalent of the reference's ``Utilities::MPI::MPI_InitFinalize``
(``/root/reference/src/main.cpp:7``) + rank-0 ``ConditionalOStream``
(``hpp:648,698``).  On a multi-host cluster each host process must join the
JAX distributed runtime before any device computation so all hosts see the
GLOBAL device set; `shard_map` over a global mesh then spans hosts with the
same code that runs single-host.

Single-process runs (the default, and everything this rig can exercise) are
a strict no-op: ``initialize_distributed()`` returns False and JAX stays
local.  Multi-host parameters come either from explicit arguments or from
the standard environment (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/
``JAX_PROCESS_ID``, or a cluster's builtin discovery where all three may be
omitted).
"""

from __future__ import annotations

import os

__all__ = [
    "initialize_distributed",
    "shutdown_distributed",
    "process_index",
    "process_count",
    "is_coordinator",
]

_initialized = False


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Join the JAX distributed runtime if this is a multi-process launch.

    Returns True if the runtime was initialized (multi-process), False for
    the single-process no-op.  Safe to call more than once.
    """
    global _initialized
    if _initialized:
        return True

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and (num_processes is None or num_processes <= 1):
        return False  # single process: nothing to do

    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True
    return True


def shutdown_distributed() -> None:
    """Leave the distributed runtime (MPI_InitFinalize's destructor half)."""
    global _initialized
    if _initialized:
        import jax

        jax.distributed.shutdown()
        _initialized = False


def process_index() -> int:
    import jax

    return jax.process_index()


def process_count() -> int:
    import jax

    return jax.process_count()


def is_coordinator() -> bool:
    """Rank-0 predicate for log gating (the reference's pcout condition,
    hpp:648)."""
    return process_index() == 0
