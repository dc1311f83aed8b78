"""The per-chunk simulation chain: one jitted program for B codewords.

Mirrors the body of ``Simulator::run_blocks`` (simulator.cc:111-169) — the
reference's per-block hot loop — as a single batched array program:

    bits -> encode -> map -> channel -> [k-means + ambiguity metrics]
         -> soft demap -> BP decode -> error counters

The whole chain runs under one ``jax.jit``; the Monte-Carlo harness
(montecarlo.py) calls it in chunks and applies the stopping rules between
launches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..code.ldpc import LDPCCode
from ..config import Config
from ..decoder.bp import DecoderTables, flooding_decode
from ..decoder.bp_em import flooding_decode_two_phase
from ..decoder.minsum import MinsumTables, layered_minsum_decode, minsum_tables
from ..detect.kmeans import make_blind_estimator
from ..detect.metric import make_ambiguity_selector
from ..io.constellation import Constellation
from ..ops.channel import fading_awgn_channel
from ..ops.encode import encoder_table, make_encoder
from ..ops.modem import ModemTables, make_mapper, make_soft_demapper
from ..ops.source import random_bits


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChainParams:
    """All large device arrays of one configuration, passed to the jitted
    chunk program as runtime arguments.

    Keeping these out of the traced program (where they would be embedded
    as constants) keeps the program small: the PEG2304 generator alone is
    1152x1152 f32, which would make a 5.4 MB serialized program that every
    compile has to carry.
    """

    gen_t: jnp.ndarray  # [K, chk] f32 encoder slab
    dec: DecoderTables
    ms: MinsumTables | None  # only when schedule == "layered-minsum"


class ChunkResult(NamedTuple):
    """Counters of one chunk (reference: SourceSink, sourcesink.cc:29-47)."""

    err_bit: jnp.ndarray  # scalar int32
    err_blk: jnp.ndarray  # scalar int32
    tot_bit: jnp.ndarray  # scalar int32
    tot_blk: jnp.ndarray  # scalar int32
    # Sum over blocks of (per-block bit-error count)^2 — the empirical
    # second moment behind the clustered-BER z-test (tools/parity.py).
    # f32: a high-FER chunk can exceed f32's exact-integer range (PEG2304
    # at B=1024 reaches ~1.4e9 vs 2^24), costing ~1e-7 relative rounding
    # per chunk; the host accumulates across chunks in Python floats.
    # Statistical use only — harmless at z-test precision.
    err_bit_sq: jnp.ndarray  # scalar f32
    metrics: jnp.ndarray  # [B, 4] f32 — |metric| table (histogram mode); zeros if known-h
    iters: jnp.ndarray  # scalar f32 — mean BP iterations executed
    # k-means inspection surface (KMeans::{clusters,idx}, kmeans.h:19-21):
    # (yr, yi, cl_r, cl_i, idx, h4_r, h4_i, hr_true, hi_true) when
    # ChainSpec.kmeans_dump is set in blind mode, else ().  The Monte-Carlo
    # driver feeds it to utils.records.dump_kmeans (DumpToMat parity).
    kmeans_diag: tuple = ()
    # Per-block debug-chatter surface (ChainSpec.debug_blocks > 0):
    # (hr_true, hi_true) known-h, + (h4_r, h4_i) in blind mode.  The
    # Monte-Carlo driver formats the reference's per-block logfile lines
    # from it (simulator.cc:124-126, kmcodec.cc:64,132-137); else ().
    debug: tuple = ()


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static recipe for one simulation configuration."""

    code: LDPCCode
    constellation: Constellation
    known_h: bool
    fading: bool
    metric_type: bool
    metric_iter: int
    max_iter: int
    encoder_active: bool
    histogram: bool
    kmeans_iters: int = 20
    kmeans_anchor: str = "max"
    # Final-decode schedule: "flooding" (reference parity),
    # "layered-minsum" (standard for 5G; decoder/minsum.py — QC fast path),
    # or "flooding-minsum" (min-sum CN rule on the flooding schedule;
    # bp_em.py cn_rule — the transcendental-free option for non-QC codes
    # like PEG8064).  Ambiguity metrics default to the flooding decoder
    # (reference soft-syndrome semantics); see metric_schedule.
    schedule: str = "flooding"
    minsum_alpha: float = 0.75
    # BP message storage dtype: "float32" (reference-parity default) or
    # "bfloat16" (opt-in: halves decoder HBM traffic; statistically — not
    # bitwise — equivalent BER/FER, see PARITY.md).  Applies to the
    # flooding final decode; ambiguity-metric decodes stay f32.
    dtype: str = "float32"
    # k-means implementation: "auto" (see kmeans_impl_for), "jax" (the
    # plain estimator, detect/kmeans.py) or "pallas" (the GPU kernel,
    # detect/kmeans_pallas.py).
    kmeans_impl: str = "auto"
    # Exact two-phase decode knobs (decoder/bp_em.py): phase-1 iteration
    # budget on the full batch, and the compacted phase-2 tile width
    # (0 = batch // 8).  Results are bit-identical for any setting; only
    # the cost changes with the operating FER.  Default re-tuned 6 -> 3 in
    # round 3: the row-state/min-sum cores made full-batch iterations
    # cheap enough that pushing stragglers to tiles earlier wins at every
    # measured operating point (blind QPSK +13%, known +22%; PEG8064 and
    # 5G rows re-measured, none regressed).
    phase1_iters: int = 3
    tile: int = 0
    # Debug: surface the k-means diagnostics (final clusters + per-symbol
    # assignments) in ChunkResult.kmeans_diag for .mat export
    # (kmeans.cc:96-111).  Blind mode only.
    kmeans_dump: bool = False
    # Per-block debug chatter: surface (true h, ĥ candidates) in
    # ChunkResult.debug so the driver can log the reference's per-block
    # lines for the first N blocks ([tpu].debug_blocks).
    debug_blocks: int = 0
    # Metric-decode schedule: "flooding" (reference-parity: kmcodec.cc
    # metric decodes run the same BP as the final decode) or "match" (use
    # the final schedule's decoder — with schedule="layered-minsum" the QC
    # fast path decodes metrics ~35x faster per iteration; an extension,
    # the reference has no min-sum).
    metric_schedule: str = "flooding"
    # Opt-in: skip the -hhat/-j*hhat metric candidates when they are
    # EXACTLY tied with the +hhat/+j*hhat ones (complement-closed
    # constellation + even-degree rows, e.g. QPSK + PEG codes — see
    # detect/metric.py complement_closed).  First-minimum tie-breaking can
    # never select the skipped pair, so the winning h is unchanged and the
    # metric stage (demap + metric over the candidate-folded batch)
    # halves.  Statistically — not bitwise — identical: an f32 ulp event
    # at a P0 == 0.5 boundary could in principle break a tie differently.
    metric_prune: bool = False

    @staticmethod
    def from_config(cfg: Config, code: LDPCCode, constellation: Constellation) -> "ChainSpec":
        return ChainSpec(
            code=code,
            constellation=constellation,
            known_h=cfg.decoder.true_h_arg,
            fading=cfg.tpu.fading,
            metric_type=cfg.xcodec.metric_type,
            metric_iter=cfg.xcodec.metric_iter,
            max_iter=cfg.ldpc.max_iter,
            encoder_active=cfg.ldpc.active,
            histogram=cfg.histogram.enable,
            schedule=cfg.tpu.schedule,
            minsum_alpha=cfg.tpu.minsum_alpha,
            dtype=cfg.tpu.dtype,
            phase1_iters=cfg.tpu.phase1_iters,
            tile=cfg.tpu.tile,
            kmeans_dump=bool(cfg.tpu.kmeans_dump_dir) and not cfg.decoder.true_h_arg,
            debug_blocks=cfg.tpu.debug_blocks,
            metric_schedule=cfg.tpu.metric_schedule,
            metric_prune=cfg.tpu.metric_prune,
            kmeans_impl=cfg.tpu.kmeans_impl,
        )


def make_chain_params(spec: ChainSpec) -> ChainParams:
    """Device-resident parameter pytree for one configuration."""
    code = spec.code
    return ChainParams(
        gen_t=encoder_table(code),
        dec=DecoderTables.from_code(code),
        ms=minsum_tables(code) if spec.schedule == "layered-minsum" else None,
    )


def target_platform() -> str:
    """Platform of the device the chain's jitted code runs on: the default
    device's (a ``jax.default_device`` scope included), else the default
    backend's ("cpu", "gpu", ...)."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def kmeans_impl_for(impl: str, platform: str) -> str:
    """The k-means implementation that ``[tpu].kmeans_impl`` names on
    ``platform``: "auto" is the kernel on "gpu" and the plain estimator on
    "cpu"; the kernel compiles only for a GPU."""
    if impl not in ("auto", "jax", "pallas"):
        raise ValueError(f"unknown kmeans_impl {impl!r}")
    if impl == "auto":
        by_platform = {"gpu": "pallas", "cpu": "jax"}
        if platform not in by_platform:
            raise ValueError(
                f"no k-means implementation for platform {platform!r} "
                "(supported: gpu, cpu)"
            )
        return by_platform[platform]
    if impl == "pallas" and platform != "gpu":
        raise ValueError(
            f'kmeans_impl = "pallas" is a GPU kernel; platform is {platform!r}'
        )
    return impl


def build_frontend_fn(
    spec: ChainSpec, batch: int, metric_fn=None
) -> Callable[[ChainParams, jax.Array, jnp.ndarray], tuple]:
    """The chain up to (but not including) the final decode.

    ``frontend(params, key, var) -> (uu, chan_llr, metrics, kmeans_diag)``:
    source bits, encode, map, channel, blind detection + ambiguity metrics
    (or known-h), soft demap.  ``chan_llr`` is ``[B, tx]`` (None only in
    histogram mode, which skips the final decode).  Factored out of
    :func:`build_chain_fn` so the model-parallel runner
    (parallel/edge_sharded.py) can pair the identical front-end with the
    edge-sharded decoder — the two paths cannot drift.

    ``metric_fn`` overrides the ambiguity-metric computation (see
    make_ambiguity_selector): the model-parallel runner passes a
    row-sharded implementation so the metric decodes' message state is
    partitioned over the mesh like the final decode's.  It wins over the
    ``metric_schedule`` decoder override.
    """
    code = spec.code
    tables = ModemTables.from_constellation(spec.constellation)
    encode = make_encoder(code, active=spec.encoder_active)
    map_bits = make_mapper(tables)
    demap = make_soft_demapper(tables)
    impl = kmeans_impl_for(spec.kmeans_impl, target_platform())
    if impl == "pallas":
        from ..detect.kmeans_pallas import make_blind_estimator_pallas

        estimate = make_blind_estimator_pallas(
            tables, spec.kmeans_iters, spec.kmeans_anchor
        )
    else:
        estimate = make_blind_estimator(tables, spec.kmeans_iters, spec.kmeans_anchor)
    if spec.kmeans_dump:
        from ..detect.kmeans import add_diagnostics

        estimate = add_diagnostics(estimate, tables)
    if spec.metric_schedule not in ("flooding", "match"):
        raise ValueError(f"unknown metric_schedule {spec.metric_schedule!r}")
    use_ms_metric = (
        spec.metric_schedule == "match" and spec.schedule == "layered-minsum"
    )
    mdecode = None
    if metric_fn is not None:
        # metric_fn replaces the whole metric computation (including any
        # metric_schedule decoder override — the caller bakes the CN rule
        # into its sharded implementation)
        use_ms_metric = False
    elif use_ms_metric:
        mdecode = lambda mt, llr, it: layered_minsum_decode(
            mt, llr, it, spec.minsum_alpha
        )
    elif spec.metric_schedule == "match" and spec.schedule == "flooding-minsum":
        from ..decoder.bp_em import flooding_decode_em

        mdecode = lambda dt, llr, it: flooding_decode_em(
            dt, llr, it, cn_rule="minsum", alpha=spec.minsum_alpha
        )
    if spec.metric_prune:
        from ..detect.metric import complement_closed

        if spec.histogram:
            raise ValueError(
                "metric_prune is incompatible with histogram mode (the "
                "metric table would carry duplicated pairs)"
            )
        if not complement_closed(code, spec.constellation):
            raise ValueError(
                "metric_prune requires a complement-closed constellation "
                "and even-degree check rows (the shipped QPSK table + PEG codes); "
                f"{spec.constellation.num_points}-point table / code "
                f"{code.name!r} do not qualify"
            )
    select = make_ambiguity_selector(
        code, tables, spec.metric_type, spec.metric_iter, decode=mdecode,
        prune_complement=spec.metric_prune, metric_fn=metric_fn,
    )
    sel_tabs = (lambda p: p.ms) if use_ms_metric else (lambda p: p.dec)

    def frontend(params: ChainParams, key: jax.Array, var: jnp.ndarray) -> tuple:
        sigma = jnp.sqrt(var)
        k_bits, k_chan = jax.random.split(key)
        uu = random_bits(k_bits, (batch, code.code_dim))
        if not spec.encoder_active:
            uu = jnp.zeros_like(uu)  # binaryldpccodec.cc:156-161
        _, cc_tx = encode(uu, params.gen_t)
        xr, xi = map_bits(cc_tx)
        yr, yi, hr_true, hi_true = fading_awgn_channel(
            k_chan, xr, xi, sigma, fading=spec.fading
        )

        chan_llr = None
        if spec.known_h:
            hr, hi = hr_true, hi_true
            if spec.histogram:
                # reference histogram mode with true_h_arg: GetHistogramData
                # over the single candidate {true_h} (simulator.cc:132-133,
                # 154-163) -> one metric per block.  Columns 1..3 are NaN
                # and dropped by the histogram writer.
                h1_r = jnp.stack([hr, hr, hr, hr], axis=1)
                h1_i = jnp.stack([hi, hi, hi, hi], axis=1)
                _, _, m4, _ = select(sel_tabs(params), yr, yi, h1_r, h1_i, var)
                metrics = jnp.concatenate(
                    [m4[:, :1], jnp.full((batch, 3), jnp.nan, jnp.float32)], axis=1
                )
            else:
                metrics = jnp.zeros((batch, 4), jnp.float32)
        kmeans_diag = ()
        if spec.known_h:
            pass
        elif spec.kmeans_dump:
            h4_r, h4_i, cl_r, cl_i, km_idx = estimate(yr, yi)
            hr, hi, metrics, chan_llr = select(sel_tabs(params), yr, yi, h4_r, h4_i, var)
            kmeans_diag = (yr, yi, cl_r, cl_i, km_idx, h4_r, h4_i, hr_true, hi_true)
        else:
            h4_r, h4_i = estimate(yr, yi)
            hr, hi, metrics, chan_llr = select(sel_tabs(params), yr, yi, h4_r, h4_i, var)

        # histogram mode skips the final decode, so no LLRs are needed
        if not spec.histogram and chan_llr is None:
            _, chan_llr = demap(yr, yi, hr, hi, var)
        debug = ()
        if spec.debug_blocks > 0:
            debug = (hr_true, hi_true)
            if not spec.known_h:
                debug = debug + (h4_r, h4_i)
        return uu, chan_llr, metrics, kmeans_diag, debug

    return frontend


def build_chain_fn(
    spec: ChainSpec, batch: int
) -> Callable[[ChainParams, jax.Array, jnp.ndarray], ChunkResult]:
    """The raw (unjitted) chunk chain: ``fn(params, key, var)``.

    Exposed separately so the sharded runner (parallel/sharding.py) can wrap
    the identical body in ``shard_map`` — single-chip and multi-chip paths
    share one implementation.  All big arrays arrive via ``params``.
    """
    code = spec.code
    if spec.schedule not in ("flooding", "layered-minsum", "flooding-minsum"):
        raise ValueError(f"unknown schedule {spec.schedule!r}")
    if spec.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown tpu.dtype {spec.dtype!r}")
    msg_dtype = jnp.float32 if spec.dtype == "float32" else jnp.bfloat16
    frontend = build_frontend_fn(spec, batch)

    def run_chunk(params: ChainParams, key: jax.Array, var: jnp.ndarray) -> ChunkResult:
        uu, chan_llr, metrics, kmeans_diag, debug = frontend(params, key, var)

        if spec.histogram:
            # histogram mode skips the final decode (simulator.cc:154-163):
            # only the metric table is of interest.
            uu_hat = jnp.zeros_like(uu)
            mean_iters = jnp.float32(0)
        else:
            if spec.schedule == "layered-minsum":
                from ..decoder.bp_em import two_phase_generic

                res = two_phase_generic(
                    lambda llr, it: layered_minsum_decode(
                        params.ms, llr, it, spec.minsum_alpha
                    ),
                    chan_llr, spec.max_iter,
                    phase1_iters=spec.phase1_iters,
                    tile=spec.tile or max(8, batch // 8),
                )
            else:
                # exact two-phase flooding (bit-identical to the plain
                # decoder; see decoder/bp_em.py).  "flooding-minsum" swaps
                # in the min-sum CN rule — same schedule, no transcendentals.
                res = flooding_decode_two_phase(
                    params.dec, chan_llr, spec.max_iter,
                    phase1_iters=spec.phase1_iters,
                    tile=spec.tile or max(8, batch // 8),
                    msg_dtype=msg_dtype,
                    cn_rule=(
                        "minsum" if spec.schedule == "flooding-minsum"
                        else "sumprod"
                    ),
                    alpha=spec.minsum_alpha,
                )
            uu_hat = res.uu_hat
            mean_iters = jnp.mean(res.iters.astype(jnp.float32))

        errs = jnp.sum((uu != uu_hat).astype(jnp.int32), axis=1)  # [B]
        errs_f = errs.astype(jnp.float32)
        return ChunkResult(
            err_bit=jnp.sum(errs),
            err_blk=jnp.sum((errs > 0).astype(jnp.int32)),
            tot_bit=jnp.int32(batch * code.code_dim),
            tot_blk=jnp.int32(batch),
            err_bit_sq=jnp.sum(errs_f * errs_f),
            metrics=metrics,
            iters=mean_iters,
            kmeans_diag=kmeans_diag,
            debug=debug,
        )

    return run_chunk


def make_chunk_runner(
    spec: ChainSpec, batch: int, chunks_per_launch: int = 1
) -> Callable[[jax.Array, jnp.ndarray], ChunkResult]:
    """Build the jitted ``run_chunk(key, var) -> ChunkResult``.

    ``var`` is a traced noise variance 10^(-SNR/10) (simulator.cc:74), so one
    compiled program serves every SNR point; the parameter pytree is bound
    here and passed as runtime arguments.

    ``chunks_per_launch > 1`` folds that many ``batch``-sized sub-chunks
    into ONE dispatch via ``lax.scan`` and returns their summed counters
    (metrics stacked to ``[n*batch, 4]``), so each launch's fixed host
    cost is paid once per ``n`` sub-chunks.  Scaling the batch itself
    instead is NOT equivalent: the two-phase decoder's compaction dynamics
    degrade above ~1024 codewords.
    """
    params = make_chain_params(spec)
    fn = _fold_launch(build_chain_fn(spec, batch), batch, max(1, chunks_per_launch))
    n = max(1, chunks_per_launch)

    jitted = jax.jit(fn)

    def run_chunk(key: jax.Array, var) -> ChunkResult:
        return jitted(params, key, var)

    run_chunk.params = params  # type: ignore[attr-defined]
    run_chunk.blocks_per_launch = n * batch  # type: ignore[attr-defined]
    # ahead-of-time form: run_chunk.lower(key, var).compile()(params, key, var)
    run_chunk.lower = lambda key, var: jitted.lower(params, key, var)  # type: ignore[attr-defined]
    return run_chunk


def _fold_launch(chain, batch: int, n: int):
    """Fold ``n`` sub-chunks of ``chain`` into one launch body (lax.scan).

    The resulting ``fn(params, key, var) -> ChunkResult`` is the unjitted
    launch program shared by :func:`make_chunk_runner` and
    :func:`make_multi_point_runner` — the per-launch key/sub-key derivation
    must be identical in both so a multi-point sweep replays the exact
    chunk sequence of the sequential path (bit-identical counters).
    """
    if n == 1:
        return chain

    def fn(params: ChainParams, key: jax.Array, var) -> ChunkResult:
        def step(carry, k):
            return carry, chain(params, k, var)

        _, rs = jax.lax.scan(step, 0, jax.random.split(key, n))
        return ChunkResult(
            err_bit=jnp.sum(rs.err_bit),
            err_blk=jnp.sum(rs.err_blk),
            tot_bit=jnp.sum(rs.tot_bit),
            tot_blk=jnp.sum(rs.tot_blk),
            err_bit_sq=jnp.sum(rs.err_bit_sq),
            metrics=rs.metrics.reshape(n * batch, -1),
            iters=jnp.mean(rs.iters),
            kmeans_diag=jax.tree.map(
                lambda a: a.reshape((n * batch,) + a.shape[2:]),
                rs.kmeans_diag,
            ),
            debug=jax.tree.map(
                lambda a: a.reshape((n * batch,) + a.shape[2:]), rs.debug
            ),
        )

    return fn


def make_multi_point_runner(
    spec: ChainSpec, batch: int, chunks_per_launch: int = 1, m: int = 2
) -> Callable[[jax.Array, jnp.ndarray], ChunkResult]:
    """One dispatch advancing ``m`` independent launches — the batched
    analogue of the reference's one-pool-thread-per-SNR-point concurrency
    (simulator.cc:27,35-42).

    ``run_launches(keys [m], vars [m]) -> ChunkResult`` with per-launch
    leading axis [m] on every counter, so the host attributes each slot to
    its SNR point and applies the per-point stopping rules unchanged.  Each
    slot runs the SAME launch program as :func:`make_chunk_runner`
    (``_fold_launch``): slot j with (key, var) of point p's launch L
    produces bit-identical counters to the sequential path's launch L of
    point p.  Short many-point sweeps (the parity configs: 7-8 points of a
    few seconds each) amortize the fixed dispatch overhead over m points
    instead of paying it per point.
    """
    params = make_chain_params(spec)
    launch = _fold_launch(build_chain_fn(spec, batch), batch, max(1, chunks_per_launch))
    n = max(1, chunks_per_launch)

    def fn(params: ChainParams, keys: jax.Array, vars_: jnp.ndarray) -> ChunkResult:
        def step(carry, kv):
            return carry, launch(params, kv[0], kv[1])

        _, rs = jax.lax.scan(step, 0, (keys, vars_))
        return rs  # stacked [m, ...]

    jitted = jax.jit(fn)

    def run_launches(keys: jax.Array, vars_) -> ChunkResult:
        return jitted(params, keys, jnp.asarray(vars_, jnp.float32))

    run_launches.params = params  # type: ignore[attr-defined]
    run_launches.blocks_per_launch = n * batch  # type: ignore[attr-defined]
    run_launches.num_slots = m  # type: ignore[attr-defined]
    return run_launches
