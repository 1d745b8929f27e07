"""Chunked, checkpointable execution of one-scan samplers.

The samplers run all steps in one ``lax.scan`` — ideal for throughput,
but a single monolithic device execution cannot be checkpointed or
observed mid-run, and a device fault late in a long execution loses all
of it.  This driver splits the
step schedule into segments, re-using ONE compiled segment function,
and between segments

* appends the segment's outputs (host-side),
* feeds summary stats to a ``monitor`` callback
  (:func:`celerite2_tpu.utils.observe.sampling_monitor`),
* saves ``{carry, outs}`` to a
  :class:`celerite2_tpu.inference.checkpoint.CheckpointManager`, so a
  killed run resumes bit-compatibly from the last completed chunk.

The reference has no checkpoint/resume at all (SURVEY.md section 5.4).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["drive_chunks"]


def _slice_sched(sched, lo, hi):
    return tuple(jnp.asarray(s[lo:hi]) for s in sched)


def drive_chunks(
    seg_fn: Callable,
    carry: Any,
    sched: Sequence[np.ndarray],
    *,
    chunk_size: Optional[int] = None,
    checkpoint=None,
    monitor: Optional[Callable] = None,
    stat_fn: Optional[Callable] = None,
    max_retries: int = 2,
    on_retry: Optional[Callable] = None,
):
    """Run ``seg_fn(carry, sched_slice) -> (carry, outs)`` over the full
    schedule, optionally in chunks.

    ``sched`` — tuple of per-step host arrays (length = total steps).
    ``chunk_size=None`` runs everything in one device execution.
    ``checkpoint`` — a ``CheckpointManager``; chunk ``i``'s state is
    saved under step ``i``, and an existing checkpoint is resumed from.
    ``monitor(step, stats)`` is called after each chunk with
    ``stat_fn(carry, outs) -> dict`` (skipped when either is None).

    ``max_retries`` — transparent fault recovery: a host-side snapshot
    of ``(carry, outs)`` is kept after
    every completed chunk, and a chunk whose execution (or device->host
    readback) raises is retried from that snapshot up to ``max_retries``
    times per chunk, re-uploading the carry to fresh device buffers.
    ``on_retry(chunk_index, attempt, exception)`` is called before each
    retry (for logging / backend re-init hooks); a warning is emitted
    otherwise.  Bit-compatibility is preserved: the retried chunk reruns
    the identical compiled segment on the identical carry.

    Returns ``(carry, outs)`` with segment outputs concatenated along
    axis 0 (step-major, as if run in one scan).
    """
    total = len(sched[0])
    seg_jit = jax.jit(seg_fn)

    if chunk_size is None or chunk_size >= total:
        carry, outs = seg_jit(carry, _slice_sched(sched, 0, total))
        if monitor is not None and stat_fn is not None:
            monitor(total, stat_fn(carry, outs))
        return carry, outs

    bounds = list(range(0, total, chunk_size)) + [total]
    segments = list(zip(bounds[:-1], bounds[1:]))

    outs_acc = None
    start_idx = 0
    sched_meta = np.asarray([int(chunk_size), int(total)], np.int64)
    if checkpoint is not None:
        latest = checkpoint.latest_step()
        if latest is not None:
            # a checkpoint written under a different chunk schedule
            # cannot be resumed bit-compatibly: validate before touching
            # segments[latest] (IndexError / silent shape mismatch when
            # chunk_size or step counts changed)
            if latest >= len(segments):
                raise ValueError(
                    f"checkpoint step {latest} does not exist in the "
                    f"current schedule ({len(segments)} chunks of "
                    f"{chunk_size}); the saved run used a different "
                    "chunk_size/total — restart or match the schedule"
                )
            lo, hi = segments[latest]
            # rebuild the restore template from known shapes: run the
            # schedule prefix shape inference with eval_shape
            probe = jax.eval_shape(
                seg_fn, carry, _slice_sched(sched, 0, hi)
            )
            template = dict(
                carry=carry,
                outs=jax.tree_util.tree_map(
                    lambda s: jnp.zeros(s.shape, s.dtype), probe[1]
                ),
                sched_meta=sched_meta,
            )
            try:
                restored = checkpoint.restore(latest, template=template)
            except Exception:
                # a checkpoint written before sched_meta existed has a
                # different tree structure and StandardRestore rejects
                # the template outright — retry without the key (the
                # latest-step bound check above still guards the
                # common schedule mismatch)
                template.pop("sched_meta")
                restored = checkpoint.restore(latest, template=template)
            saved_meta = np.asarray(restored.get("sched_meta", sched_meta))
            if not np.array_equal(saved_meta, sched_meta):
                raise ValueError(
                    f"checkpoint was written with (chunk_size, total) = "
                    f"{tuple(saved_meta)}, current run uses "
                    f"{tuple(sched_meta)}; resume requires an identical "
                    "chunk schedule"
                )
            carry = restored["carry"]
            outs_acc = restored["outs"]
            start_idx = latest + 1

    # host-side restart point: survives a device/worker crash even when
    # no CheckpointManager is attached
    carry_host = jax.tree_util.tree_map(np.asarray, carry)

    for i in range(start_idx, len(segments)):
        lo, hi = segments[i]
        attempt = 0
        while True:
            try:
                carry_new, outs = seg_jit(
                    carry, _slice_sched(sched, lo, hi)
                )
                # the readback is where a dead worker actually surfaces:
                # force it inside the retry scope
                outs = jax.tree_util.tree_map(np.asarray, outs)
                carry_host_new = jax.tree_util.tree_map(
                    np.asarray, carry_new
                )
                break
            except Exception as exc:  # noqa: BLE001 - worker crashes
                # surface as RuntimeError/XlaRuntimeError, not a stable type
                attempt += 1
                if attempt > max_retries:
                    raise
                if on_retry is not None:
                    on_retry(i, attempt, exc)
                else:
                    warnings.warn(
                        f"chunk {i} failed ({type(exc).__name__}: {exc});"
                        f" retrying from the last completed chunk"
                        f" (attempt {attempt}/{max_retries})",
                        stacklevel=2,
                    )
                # re-upload from the host snapshot: the old device
                # buffers may belong to a dead worker
                carry = jax.tree_util.tree_map(jnp.asarray, carry_host)
        carry = carry_new
        carry_host = carry_host_new
        if outs_acc is None:
            outs_acc = outs
        else:
            outs_acc = jax.tree_util.tree_map(
                lambda a, b: np.concatenate([a, b], axis=0),
                outs_acc,
                outs,
            )
        if checkpoint is not None:
            checkpoint.save(
                i,
                dict(
                    carry=carry_host,
                    outs=outs_acc,
                    sched_meta=sched_meta,
                ),
            )
        if monitor is not None and stat_fn is not None:
            monitor(hi, stat_fn(carry, outs))

    return carry, jax.tree_util.tree_map(jnp.asarray, outs_acc)
