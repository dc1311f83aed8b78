"""Edge-sharded flooding BP: the message state partitioned over the mesh.

SURVEY.md §2 (parallelism table): the reference is a CPU simulator with no
tensor partitioning anywhere; the batched analogue of "scaling a long
sequence" is sharding the Monte-Carlo batch (parallel/sharding.py) **and,
for the huge PEG8064 code, sharding the BP messages over the edge
dimension**.  This module is that second axis — model parallelism for the
decoder itself:

* Check-node rows (and therefore their edges) are partitioned into
  contiguous slabs over a ``model`` mesh axis: device d owns
  ``c2v[d]: [drm, nr/D, B]`` — for PEG8064 at B=1024 f32 that is 99 MB of
  message state split D ways, so codes (or batches) whose message state
  exceeds one device's memory decode without spilling.
* Per iteration exactly ONE collective runs: each device scatter-adds its
  local check-to-variable messages into a partial column-sum ``[nc, B]``
  and a ``psum`` over the ``model`` axis materializes the full variable-
  node posterior on every device (33 MB for PEG8064 at B=1024, over the
  device interconnect).  Everything else (hard decision, local syndrome slab, CN
  update with either CN rule) is device-local.
* The iteration order, 1e-12 clip, per-codeword convergence freezing, and
  both CN rules ("sumprod" Gallager-phi / "minsum") match the single-chip
  cores (decoder/bp_em.py; reference semantics binaryldpccodec.cc:164-278).
  Outputs are decision-identical to the single-chip decoder in practice
  but not bit-pinned: the posterior's column sums accumulate in psum order
  instead of slot order, an f32 reordering of the same values (the
  single-chip path remains the bit-pinned-to-oracle one; tests assert
  exact decision/convergence/iteration agreement on fixed seeds).

Like the reference's thread pool (but unlike its mutexed counters), the
partitioning is invisible to the caller: ``make_edge_sharded_decoder``
returns a ``decode(chan_llr, iter_count) -> DecodeResult`` with the same
interface as ``flooding_decode_em``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import constants
from ..code.ldpc import LDPCCode
from ..decoder.bp import DecodeResult, DecoderTables
from ..decoder.bp_em import _cn_minsum, _cn_sumprod


def _row_slab_tables(t: DecoderTables, ndev: int):
    """Host-side row-slab tables, padded so ``num_row`` divides the mesh.

    Returns (row_col [nr_pad, drm] int32 with nc = pad, rmask [nr_pad, drm]
    f32, nr_pad).  Pad rows are all-pad slots: they gather the +1.0 pad
    posterior row (never trips the syndrome) and write zero messages.
    """
    row_col = np.asarray(t.row_edge_col)  # [nr, drm], nc = pad
    rmask = np.asarray(t.row_mask_sm).T  # [nr, drm]
    nr, drm = row_col.shape
    nr_pad = -(-nr // ndev) * ndev
    if nr_pad != nr:
        pad = nr_pad - nr
        row_col = np.concatenate(
            [row_col, np.full((pad, drm), t.num_col, np.int32)], axis=0
        )
        rmask = np.concatenate([rmask, np.zeros((pad, drm), np.float32)], axis=0)
    return (
        jnp.asarray(row_col, jnp.int32),
        jnp.asarray(rmask, jnp.float32),
        nr_pad,
    )


def _make_device_decode(
    t: DecoderTables, axis: str, cn_rule: str, alpha: float
) -> Callable:
    """The device-local slab decoder, for composition inside a shard_map.

    ``device_decode(row_col, rmask, llr_col, iter_count)`` runs one device's
    row slab with exactly one ``psum`` over ``axis`` per iteration (plus the
    cheap unsat-count psum).  Shared by :func:`make_edge_sharded_decoder`
    (standalone decode interface) and
    :func:`make_model_parallel_chunk_runner` (full chain) so the two cannot
    drift.
    """
    if cn_rule not in ("sumprod", "minsum"):
        raise ValueError(f"unknown cn_rule {cn_rule!r}")
    nc = t.num_col
    llr_clip = jnp.float32(constants.LLR_CLIP)
    alpha_f = jnp.float32(alpha)

    def device_decode(row_col, rmask, llr_col, iter_count):
        """One device's slab. row_col/rmask: [nrD, drm]; llr_col: [nc, B]
        replicated."""
        nrD, drm = row_col.shape
        b = llr_col.shape[1]
        # slot-major within the slab: [drm, nrD]
        cols_sm = row_col.T.reshape(-1)  # [drm * nrD], nc = pad
        rmask_sm = rmask.T[:, :, None]  # [drm, nrD, 1]

        def body(state):
            i, c2v, cc_hat, conv, iters, ss = state  # c2v [drm, nrD, B]
            # --- partial column sums + ONE psum -> full posterior ---
            partial = jnp.zeros((nc + 1, b), jnp.float32).at[cols_sm].add(
                c2v.reshape(-1, b)
            )
            colsum = jax.lax.psum(partial[:nc], axis)
            post = llr_col + colsum  # [nc, B] replicated
            hard = (post <= 0).astype(jnp.int8)
            cc_hat = jnp.where(conv[None, :], cc_hat, hard)
            # --- local syndrome slab; global AND via psum of unsat counts ---
            post_pad = jnp.concatenate([post, jnp.ones((1, b), jnp.float32)], 0)
            post_edge = post_pad[cols_sm].reshape(drm, nrD, b)
            parity = jnp.sum((post_edge <= 0).astype(jnp.int32), axis=0) % 2
            unsat = jax.lax.psum(jnp.sum(parity, axis=0), axis)  # [B]
            ok = unsat == 0
            iters = iters + (~conv).astype(jnp.int32)
            conv_after = conv | ok
            # --- local CN update: the SAME helpers as the single-chip
            # cores (decoder/bp_em.py), so the two cannot drift; pad
            # slots write 0 via the mask ---
            v2c = post_edge - c2v
            if cn_rule == "minsum":
                c2v_new, ss_new = _cn_minsum(v2c, rmask_sm, alpha_f, llr_clip)
            else:
                c2v_new, ss_new = _cn_sumprod(v2c, rmask_sm, llr_clip)
            c2v = c2v_new * rmask_sm
            ss = jnp.where(conv_after[None, :], ss, ss_new)
            return i + 1, c2v, cc_hat, conv_after, iters, ss

        def cond(state):
            i, _, _, conv, _, _ = state
            return jnp.logical_and(i < iter_count, ~jnp.all(conv))

        state = (
            jnp.int32(0),
            jnp.zeros((drm, nrD, b), jnp.float32),
            jnp.zeros((nc, b), jnp.int8),
            jnp.zeros((b,), bool),
            jnp.zeros((b,), jnp.int32),
            jnp.ones((nrD, b), jnp.float32),
        )
        _, _, cc_hat, conv, iters, ss = jax.lax.while_loop(cond, body, state)
        return cc_hat, conv, iters, ss

    return device_decode


def _make_two_phase_device(device_decode, phase1_iters: int, tile: int):
    """Exact two-phase schedule around a device-local slab decoder.

    The row-sharded analogue of ``bp_em.flooding_decode_two_phase`` (the
    per-codeword early exit of binaryldpccodec.cc:217-232, recovered for
    batches): phase 1 runs ``phase1_iters`` on the full batch; the
    still-unconverged codewords are compacted into ``tile``-wide
    sub-batches and re-decoded from scratch at the full budget.  BP is
    deterministic and per-codeword independent (the posterior psum sums
    per-column, so a codeword's trajectory does not depend on its batch
    neighbors), hence the outputs are BIT-identical to the single-phase
    slab decoder — only the schedule of wasted work changes.

    Safe inside ``shard_map``: ``conv`` (and therefore ``order`` /
    ``n_unconv`` / the tile-loop trip count) derives from psum-replicated
    values, so every device of a model group executes the same number of
    tile iterations and the per-tile psums stay collective-matched.
    ``phase1_iters <= 0`` disables the wrapper (single-phase).
    """

    def decode2(row_col, rmask, llr_col, iter_count):
        b = llr_col.shape[1]
        t_ = min(max(8, tile), b)
        if t_ >= b or phase1_iters <= 0 or phase1_iters >= iter_count:
            return device_decode(row_col, rmask, llr_col, iter_count)
        cc, conv, iters, ss = device_decode(row_col, rmask, llr_col, phase1_iters)
        order = jnp.argsort(conv, stable=True)  # unconverged first
        n_unconv = jnp.sum(~conv).astype(jnp.int32)

        def cond(st):
            return st[0] * t_ < n_unconv

        def body(st):
            k, cc, conv, iters, ss = st
            start = jnp.minimum(k * t_, b - t_)
            idx = jax.lax.dynamic_slice_in_dim(order, start, t_)
            scc, sconv, siters, sss = device_decode(
                row_col, rmask, llr_col[:, idx], iter_count
            )
            return (
                k + 1,
                cc.at[:, idx].set(scc),
                conv.at[idx].set(sconv),
                iters.at[idx].set(siters),
                ss.at[:, idx].set(sss),
            )

        _, cc, conv, iters, ss = jax.lax.while_loop(
            cond, body, (jnp.int32(0), cc, conv, iters, ss)
        )
        return cc, conv, iters, ss

    return decode2


def make_edge_sharded_decoder(
    code: LDPCCode,
    mesh: Mesh,
    axis: str = "model",
    cn_rule: str = "sumprod",
    alpha: float = 0.75,
    phase1_iters: int = 0,
    tile: int = 0,
) -> Callable[[jnp.ndarray, int], DecodeResult]:
    """Row-sharded flooding decoder over ``mesh``'s ``axis``.

    ``decode(chan_llr [B, tx], iter_count) -> DecodeResult`` — same
    interface and semantics as ``bp_em.flooding_decode_em`` (puncture
    prior-insertion included), message state sharded over the mesh.

    ``phase1_iters > 0`` enables the exact two-phase schedule
    (:func:`_make_two_phase_device`): bit-identical outputs, compacted
    phase-2 tiles of ``tile`` codewords (0 = batch // 8).
    """
    t = DecoderTables.from_code(code)
    ndev = int(mesh.shape[axis])  # KeyError here for a misnamed axis
    row_col_all, rmask_all, nr_pad = _row_slab_tables(t, ndev)
    nr = t.num_row
    device_decode = _make_device_decode(t, axis, cn_rule, alpha)

    def sharded_fn(row_col, rmask, llr_col, iter_count):
        b = llr_col.shape[1]
        dec = _make_two_phase_device(
            device_decode, phase1_iters, tile or max(8, b // 8)
        )
        return jax.shard_map(
            lambda rc, rm, llr: dec(rc, rm, llr, iter_count),
            mesh=mesh,
            in_specs=(P(axis), P(axis), P()),
            out_specs=(P(), P(), P(), P(axis)),
            # same zeros-meet-sharded while_loop carry issue as
            # make_sharded_chunk_runner
            check_vma=False,
        )(row_col, rmask, llr_col)

    jitted = jax.jit(sharded_fn, static_argnums=3)

    def decode(chan_llr: jnp.ndarray, iter_count: int) -> DecodeResult:
        llr_tx = jnp.asarray(chan_llr, jnp.float32).T  # [tx, B]
        if t.punct:
            b = llr_tx.shape[1]
            llr_tx = jnp.concatenate(
                [jnp.zeros((t.punct, b), jnp.float32), llr_tx], axis=0
            )
        cc_hat, conv, iters, ss = jitted(row_col_all, rmask_all, llr_tx, iter_count)
        uu_hat = jax.lax.dynamic_slice_in_dim(cc_hat, t.info_start, t.code_dim, 0)
        return DecodeResult(uu_hat.T, cc_hat.T, conv, iters, ss[:nr].T)

    decode.tables = t  # type: ignore[attr-defined]
    decode.num_shards = ndev  # type: ignore[attr-defined]
    return decode


def get_mesh_2d(ndata: int, nmodel: int, devices=None) -> Mesh:
    """(data x model) 2-D mesh over the first ``ndata * nmodel`` devices.

    ``model`` is the minor axis so each data row's model group sits on
    adjacent devices — the per-iteration posterior psum stays within a
    group, while the (once-per-chunk) data-axis counter psum crosses
    rows.
    """
    if devices is None:
        devices = jax.devices()
    need = ndata * nmodel
    if len(devices) < need:
        raise ValueError(
            f"mesh ({ndata} data x {nmodel} model) needs {need} devices, "
            f"have {len(devices)}"
        )
    return Mesh(
        np.asarray(devices[:need]).reshape(ndata, nmodel), ("data", "model")
    )


def make_model_parallel_chunk_runner(
    spec, batch: int, mesh: Mesh, chunks_per_launch: int = 1
):
    """Full-chain chunk runner over a (data x model) mesh: the front-end is
    data-parallel, the FINAL decode's message state is row-sharded over the
    ``model`` axis.

    The configuration-reachable form of the edge-sharded decoder
    (``[tpu].model_parallel``): codes/batches whose message state exceeds
    one chip's HBM (PEG8064 at B=1024 f32 is 99 MB of c2v state) decode
    end-to-end without spilling.  Semantics match the data-parallel runner
    (parallel/sharding.py): same front-end (build_frontend_fn — shared
    code), same counter psums; the decode itself is two-phase edge-sharded
    flooding, decision-identical in practice to the single-chip two-phase
    decoder (see the module docstring's f32 psum-ordering note).

    Limitations (named errors below): the layered min-sum schedule has no
    row-sharded formulation (QC layers are rolls, not row slabs), and
    histogram/kmeans-dump modes are diagnostic paths that never need model
    parallelism.

    In blind mode the whole metric stage is row-sharded too (round 5): the
    4-candidate metric decodes (detect/metric.py, the analogue of
    kmcodec.cc:121-142) run through the same device-local slab decoder as
    the final decode via the ``metric_fn`` injection point, and the
    hard-metric parity counts run on the local row slab with one psum — so
    peak per-device live message state at the candidate-folded
    ``[4 * B_local]`` batch is reduced ~D x, which is the feature's whole
    purpose for message states larger than one chip's HBM.  The final
    decode runs the exact two-phase schedule (``phase1_iters``/``tile``
    from the spec, bit-identical to single-phase — see
    :func:`_make_two_phase_device`), recovering the per-codeword early
    exit the single-chip chain has had since round 1.
    """
    from ..sim.chain import ChunkResult, build_frontend_fn, make_chain_params

    for ax in ("data", "model"):
        if ax not in mesh.shape:
            raise ValueError(f"mesh must have a {ax!r} axis, has {mesh.axis_names}")
    ndata = int(mesh.shape["data"])
    nmodel = int(mesh.shape["model"])
    if spec.histogram:
        raise ValueError("model_parallel does not support histogram mode")
    if spec.kmeans_dump:
        raise ValueError("model_parallel does not support kmeans_dump")
    if spec.schedule == "layered-minsum":
        raise ValueError(
            "model_parallel requires a flooding schedule "
            '("flooding" or "flooding-minsum"); the layered min-sum QC '
            "fast path has no row-sharded formulation"
        )
    # this runner bypasses build_chain_fn, so its schedule/dtype checks
    # must be replicated — a typo'd knob must not silently pick a default
    if spec.schedule not in ("flooding", "flooding-minsum"):
        raise ValueError(f"unknown schedule {spec.schedule!r}")
    if spec.dtype != "float32":
        raise ValueError(
            "model_parallel decodes in float32 only "
            f"(got tpu.dtype {spec.dtype!r}); the row-sharded core keeps "
            "its c2v state f32"
        )
    cn_rule = "minsum" if spec.schedule == "flooding-minsum" else "sumprod"
    if batch % ndata != 0:
        raise ValueError(f"batch {batch} not divisible by data axis {ndata}")
    local_batch = batch // ndata
    code = spec.code
    params = make_chain_params(spec)
    t = params.dec
    row_col_all, rmask_all, _ = _row_slab_tables(t, nmodel)
    device_decode = _make_device_decode(t, "model", cn_rule, spec.minsum_alpha)
    decode_final = _make_two_phase_device(
        device_decode, spec.phase1_iters, spec.tile or max(8, local_batch // 8)
    )
    n = max(1, chunks_per_launch)

    # --- row-sharded metric stage (blind mode) -----------------------------
    # The metric decodes are plain flooding at metric_iter iterations
    # (kmcodec.cc:147-159); under metric_schedule="match" with the
    # flooding-minsum final schedule they use the min-sum CN rule, exactly
    # like build_frontend_fn's device-local override.  ``_cell`` carries the
    # per-trace local slab tables from one_chunk into the metric_fn closure
    # (build_frontend_fn is built once, but metric_fn's body is traced
    # inside one_chunk where the sharded row_col/rmask tracers live).
    metric_cn = (
        "minsum"
        if spec.metric_schedule == "match" and spec.schedule == "flooding-minsum"
        else "sumprod"
    )
    device_decode_metric = _make_device_decode(t, "model", metric_cn, spec.minsum_alpha)
    needs_decode = spec.metric_type or code.is_5g
    _cell: dict = {}

    def _local_failed_checks(row_col, bits_col):
        """Failed-parity count of a replicated [nc, B] 0/1 word over the
        LOCAL row slab, psum'd over the model axis — the row-sharded
        ParityCheck (binaryldpccodec.cc:280-299).  Pad rows gather the
        appended 0 row on every slot -> parity 0, no contribution."""
        nrD, drm = row_col.shape
        b = bits_col.shape[1]
        cols = row_col.T.reshape(-1)
        bits_pad = jnp.concatenate(
            [bits_col.astype(jnp.int32), jnp.zeros((1, b), jnp.int32)], axis=0
        )
        parity = jnp.sum(bits_pad[cols].reshape(drm, nrD, b), axis=0) % 2
        return jax.lax.psum(jnp.sum(parity, axis=0), "model")  # [B]

    def sharded_metric_fn(tabs, bit_p0, chan_llr):
        row_col, rmask = _cell["rc"], _cell["rm"]
        if not needs_decode:
            # classic hard metric: inverted hard decision, no decoding
            # (kmcodec.cc:109-114) — count on the local slab
            rr = (bit_p0 > 0.5).astype(jnp.int8).T  # [nc, B_folded]
            return _local_failed_checks(row_col, rr).astype(jnp.float32)
        llr_col = jnp.asarray(chan_llr, jnp.float32).T
        if t.punct:
            bfold = llr_col.shape[1]
            llr_col = jnp.concatenate(
                [jnp.zeros((t.punct, bfold), jnp.float32), llr_col], axis=0
            )
        cc_hat, _, _, ss = device_decode_metric(
            row_col, rmask, llr_col, spec.metric_iter
        )
        if spec.metric_type:
            # soft metric: sum of log soft-syndromes (kmcodec.cc:147-155)
            # over the local real rows (+ pad rows contribute log 1 = 0),
            # psum'd over the model axis
            return jax.lax.psum(jnp.sum(jnp.log(ss), axis=0), "model")
        return _local_failed_checks(row_col, cc_hat).astype(jnp.float32)

    frontend = build_frontend_fn(
        spec, local_batch,
        metric_fn=None if spec.known_h else sharded_metric_fn,
    )

    def one_chunk(p, row_col, rmask, key, var):
        _cell["rc"], _cell["rm"] = row_col, rmask
        uu, chan_llr, metrics, _, debug = frontend(p, key, var)
        llr_col = jnp.asarray(chan_llr, jnp.float32).T  # [tx, B_local]
        if t.punct:
            llr_col = jnp.concatenate(
                [jnp.zeros((t.punct, local_batch), jnp.float32), llr_col], axis=0
            )
        cc_hat, _, iters, _ = decode_final(row_col, rmask, llr_col, spec.max_iter)
        uu_hat = jax.lax.dynamic_slice_in_dim(cc_hat, t.info_start, t.code_dim, 0).T
        errs = jnp.sum((uu != uu_hat).astype(jnp.int32), axis=1)  # [B_local]
        errs_f = errs.astype(jnp.float32)
        return ChunkResult(
            err_bit=jnp.sum(errs),
            err_blk=jnp.sum((errs > 0).astype(jnp.int32)),
            tot_bit=jnp.int32(local_batch * code.code_dim),
            tot_blk=jnp.int32(local_batch),
            err_bit_sq=jnp.sum(errs_f * errs_f),
            metrics=metrics,
            iters=jnp.mean(iters.astype(jnp.float32)),
            kmeans_diag=(),
            debug=debug,
        )

    def per_device(p, row_col, rmask, keys, var):
        if n == 1:
            res = one_chunk(p, row_col, rmask, keys[0], var)
        else:

            def step(carry, k):
                return carry, one_chunk(p, row_col, rmask, k, var)

            _, rs = jax.lax.scan(step, 0, jax.random.split(keys[0], n))
            res = ChunkResult(
                err_bit=jnp.sum(rs.err_bit),
                err_blk=jnp.sum(rs.err_blk),
                tot_bit=jnp.sum(rs.tot_bit),
                tot_blk=jnp.sum(rs.tot_blk),
                err_bit_sq=jnp.sum(rs.err_bit_sq),
                metrics=rs.metrics.reshape(n * local_batch, -1),
                iters=jnp.mean(rs.iters),
                kmeans_diag=(),
                debug=jax.tree.map(
                    lambda a: a.reshape((n * local_batch,) + a.shape[2:]),
                    rs.debug,
                ),
            )
        # counters are identical on every model device of a data row (the
        # decode's posterior is psum-replicated over "model"), so the
        # reduction runs over "data" only; psumming over "model" too would
        # multiply every count by nmodel.
        return ChunkResult(
            err_bit=jax.lax.psum(res.err_bit, "data"),
            err_blk=jax.lax.psum(res.err_blk, "data"),
            tot_bit=jax.lax.psum(res.tot_bit, "data"),
            tot_blk=jax.lax.psum(res.tot_blk, "data"),
            err_bit_sq=jax.lax.psum(res.err_bit_sq, "data"),
            metrics=res.metrics,
            iters=jax.lax.pmean(res.iters, "data"),
            kmeans_diag=(),
            debug=res.debug,
        )

    sharded = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P("model"), P("model"), P("data"), P()),
        out_specs=ChunkResult(
            err_bit=P(), err_blk=P(), tot_bit=P(), tot_blk=P(),
            err_bit_sq=P(), metrics=P("data"), iters=P(),
            kmeans_diag=P(), debug=P("data"),
        ),
        # same zeros-meet-sharded while_loop carry issue as
        # make_sharded_chunk_runner
        check_vma=False,
    )

    jitted = jax.jit(sharded)

    def run_chunk(key: jax.Array, var) -> ChunkResult:
        keys = jax.random.split(key, ndata)
        return jitted(params, row_col_all, rmask_all, keys, var)

    run_chunk.params = params  # type: ignore[attr-defined]
    run_chunk.blocks_per_launch = n * batch  # type: ignore[attr-defined]
    run_chunk.num_row_shards = nmodel  # type: ignore[attr-defined]
    return run_chunk
