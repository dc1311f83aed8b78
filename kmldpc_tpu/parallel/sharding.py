"""Device-mesh parallelism for the Monte-Carlo chain.

The reference's two thread pools (one thread per SNR point, an inner pool
over block chunks sharing a mutexed counter object — simulator.cc:27-103,
thread_pool.h) map onto a 1-D device mesh:

* the Monte-Carlo batch dimension is sharded over the ``data`` axis via
  ``shard_map`` — each device simulates ``batch / D`` codewords with its own
  counter-derived PRNG key (replacing the reference's racy shared RNG
  singletons, randnum.cc:89-93);
* the mutexed ``threadsafe_sourcesink`` aggregation becomes one
  ``psum`` of the int32 counter pytree (threadsafe_sourcesink.cc ->
  jax.lax.psum), so counters land replicated on every device and the host
  reads them without extra transfers;
* multi-host runs reuse the same code: ``jax.distributed.initialize`` +
  ``jax.devices()`` makes the mesh span hosts, with the same psum.

The chunk program itself is unchanged — ``make_chunk_runner``'s chain runs
per shard — so single-chip and multi-chip paths cannot drift apart.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..sim.chain import (
    ChainSpec,
    ChunkResult,
    _fold_launch,
    build_chain_fn,
    make_chain_params,
)


def get_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the visible (or given) devices."""
    if devices is None:
        devices = jax.devices()
        if num_devices is not None:
            devices = devices[:num_devices]
    return Mesh(np.asarray(devices), ("data",))


def make_sharded_chunk_runner(
    spec: ChainSpec, batch: int, mesh: Mesh, chunks_per_launch: int = 1
) -> Callable[[jax.Array, jnp.ndarray], ChunkResult]:
    """Build ``run_chunk(key, var)`` sharded over ``mesh``'s ``data`` axis.

    ``batch`` is the *global* chunk size; it must divide evenly by the mesh
    size.  Counters come back replicated (already psum-reduced); the metric
    table stays batch-sharded.  ``chunks_per_launch > 1`` folds that many
    sub-chunks into one dispatch per device (same fixed-launch-overhead
    amortization as the single-chip runner, sim/chain.py).
    """
    ndev = mesh.devices.size
    if batch % ndev != 0:
        raise ValueError(f"batch {batch} not divisible by mesh size {ndev}")
    local_batch = batch // ndev
    chain = build_chain_fn(spec, local_batch)
    params = make_chain_params(spec)
    n = max(1, chunks_per_launch)

    # per-device launch body: n sub-chunks folded, same key derivation as
    # the single-chip runner (sim/chain.py _fold_launch — shared code)
    local_chunks = _fold_launch(chain, local_batch, n)

    def per_device(p, keys: jax.Array, var: jnp.ndarray) -> ChunkResult:
        res = local_chunks(p, keys[0], var)
        return ChunkResult(
            err_bit=jax.lax.psum(res.err_bit, "data"),
            err_blk=jax.lax.psum(res.err_blk, "data"),
            tot_bit=jax.lax.psum(res.tot_bit, "data"),
            tot_blk=jax.lax.psum(res.tot_blk, "data"),
            err_bit_sq=jax.lax.psum(res.err_bit_sq, "data"),
            metrics=res.metrics,
            iters=jax.lax.pmean(res.iters, "data"),
            kmeans_diag=res.kmeans_diag,
            debug=res.debug,
        )

    sharded = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P("data"), P()),
        out_specs=ChunkResult(
            err_bit=P(), err_blk=P(), tot_bit=P(), tot_blk=P(),
            err_bit_sq=P(), metrics=P("data"), iters=P(),
            kmeans_diag=P("data"), debug=P("data"),
        ),
        # The decoder's while_loop initializes its carries with unvarying
        # zeros that meet data-sharded values at the first iteration; the
        # varying-manual-axes checker rejects that mix even though the
        # program is correct, so it is disabled here.
        check_vma=False,
    )

    jitted = jax.jit(
        lambda p, keys, var: sharded(p, keys, var)
    )

    def run_chunk(key: jax.Array, var: jnp.ndarray) -> ChunkResult:
        keys = jax.random.split(key, ndev)
        return jitted(params, keys, var)

    run_chunk.params = params  # type: ignore[attr-defined]
    run_chunk.blocks_per_launch = n * batch  # type: ignore[attr-defined]
    return run_chunk


def make_sharded_multi_point_runner(
    spec: ChainSpec, batch: int, mesh: Mesh, chunks_per_launch: int = 1,
    m: int = 2,
) -> Callable[[jax.Array, jnp.ndarray], ChunkResult]:
    """Data-parallel + SNR-point folding composed: one dispatch advances
    ``m`` whole launches, each sharded over the ``data`` axis.

    The multi-chip form of ``sim.chain.make_multi_point_runner`` (the
    reference's one-pool-thread-per-SNR-point concurrency,
    simulator.cc:27,35-42): ``run_launches(keys [m], vars [m]) ->
    ChunkResult`` with per-launch leading axis [m] on the counters.  Slot
    j splits its key over the mesh exactly as
    :func:`make_sharded_chunk_runner` does, so each slot's counters are
    bit-identical to the sequential sharded path's launch with the same
    (key, var).
    """
    ndev = mesh.devices.size
    if batch % ndev != 0:
        raise ValueError(f"batch {batch} not divisible by mesh size {ndev}")
    local_batch = batch // ndev
    n = max(1, chunks_per_launch)
    params = make_chain_params(spec)
    local_launch = _fold_launch(build_chain_fn(spec, local_batch), local_batch, n)

    def per_device(p, keys: jax.Array, vars_: jnp.ndarray) -> ChunkResult:
        # keys: [m, 1] (slot-major, this device's column)
        def step(carry, kv):
            k, v = kv
            res = local_launch(p, k, v)
            return carry, ChunkResult(
                err_bit=jax.lax.psum(res.err_bit, "data"),
                err_blk=jax.lax.psum(res.err_blk, "data"),
                tot_bit=jax.lax.psum(res.tot_bit, "data"),
                tot_blk=jax.lax.psum(res.tot_blk, "data"),
                err_bit_sq=jax.lax.psum(res.err_bit_sq, "data"),
                metrics=res.metrics,
                iters=jax.lax.pmean(res.iters, "data"),
                kmeans_diag=res.kmeans_diag,
                debug=res.debug,
            )

        _, rs = jax.lax.scan(step, 0, (keys[:, 0], vars_))
        return rs  # stacked [m, ...]

    sharded = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(None, "data"), P()),
        out_specs=ChunkResult(
            err_bit=P(), err_blk=P(), tot_bit=P(), tot_blk=P(),
            err_bit_sq=P(), metrics=P(None, "data"), iters=P(),
            kmeans_diag=P(None, "data"), debug=P(None, "data"),
        ),
        # same zeros-meet-sharded while_loop carry issue as above
        check_vma=False,
    )

    jitted = jax.jit(sharded)

    def run_launches(keys: jax.Array, vars_) -> ChunkResult:
        # slot keys split over devices exactly like the sequential path
        keys2 = jax.vmap(lambda k: jax.random.split(k, ndev))(keys)  # [m, ndev]
        return jitted(params, keys2, jnp.asarray(vars_, jnp.float32))

    run_launches.params = params  # type: ignore[attr-defined]
    run_launches.blocks_per_launch = n * batch  # type: ignore[attr-defined]
    run_launches.num_slots = m  # type: ignore[attr-defined]
    return run_launches
