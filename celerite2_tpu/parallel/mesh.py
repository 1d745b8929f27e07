"""Mesh construction and multi-host runtime helpers.

The framework's two parallel axes (SURVEY.md section 2.4):
  * ``chains`` — data parallelism over NUTS/HMC chains / SMC particles
    (embarrassingly parallel; collectives only for adaptation stats),
  * ``seq`` — sequence parallelism over the length-N recursions
    (O(J^2) boundary carries exchanged between neighbor devices).

Multi-host wiring (SURVEY.md section 5.8): call
:func:`initialize_distributed` once per process before any jax call
that touches devices, then build the mesh with ``make_mesh`` — it spans
every process's devices and, when more than one host participates, lays
the mesh out host-major so that the CHAINS axis crosses the network
between hosts (embarrassingly parallel — only scalar adaptation psums
leave a host) while the SEQ axis, which exchanges O(J^2) carries every
likelihood, stays on the NVLink fabric inside each host.  Within one
host every GPU reaches every other at the same NVLink rate, so the
single-host mesh shape follows the algorithm alone.

Launch example (one process per host)::

    # host 0                       # host 1
    python train.py --pid 0        python train.py --pid 1

    # in train.py
    initialize_distributed(
        coordinator_address="host0:8476", num_processes=2,
        process_id=args.pid,
    )
    mesh = make_mesh(chains=8, seq=2)
"""

from __future__ import annotations

import logging

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "chain_sharding",
    "seq_sharding",
    "P",
]

logger = logging.getLogger("celerite2_tpu")


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> None:
    """Join the multi-process JAX runtime (wraps
    ``jax.distributed.initialize``).

    With no arguments, cluster auto-detection is used (schedulers such
    as SLURM set the environment for it); elsewhere pass
    ``coordinator_address`` (e.g. ``"localhost:8476"`` for several
    processes on one host), ``num_processes`` and ``process_id``.  Safe
    to call when
    already initialized (logged and ignored).
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as exc:
        if "already initialized" in str(exc).lower():
            logger.info("jax.distributed already initialized; ignoring")
            return
        raise
    logger.info(
        "distributed runtime up: process %d / %d, %d local of %d "
        "global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def make_mesh(chains: int = 1, seq: int = 1, *, devices=None) -> Mesh:
    """Build a (chains, seq) mesh over the available devices.

    Multi-process: devices are arranged host-major, so contiguous
    ``seq`` groups live inside one host (carry exchanges ride NVLink)
    and the ``chains`` axis spans hosts (the inter-host network carries
    only adaptation scalars).  ``seq`` must therefore divide the per-host device count
    when more than one process participates.
    """
    devices = list(devices) if devices is not None else jax.devices()
    n = chains * seq
    if n > len(devices):
        raise ValueError(
            f"mesh ({chains} x {seq}) needs {n} devices, have "
            f"{len(devices)}"
        )
    if jax.process_count() > 1:
        per_host = jax.local_device_count()
        if seq > per_host or per_host % seq:
            raise ValueError(
                f"seq={seq} must divide the per-host device count "
                f"({per_host}) so sequence carries stay inside a host"
            )
        # jax.devices() is already process-major; keep that order so
        # each host contributes whole seq-groups
        devices = sorted(
            devices, key=lambda d: (d.process_index, d.id)
        )
    dev = np.asarray(devices[:n]).reshape(chains, seq)
    return Mesh(dev, axis_names=("chains", "seq"))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis = chains."""
    return NamedSharding(mesh, P("chains"))


def seq_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis = time/sequence."""
    return NamedSharding(mesh, P("seq"))
