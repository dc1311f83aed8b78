"""Monte-Carlo harness: SNR sweep, stopping rules, telemetry, checkpointing.

Replaces the reference's two-level thread-pool scheduler
(``Simulator::{Simulate,run,run_blocks}``, simulator.cc:24-169) with a host
driver loop around one jitted chunk program:

* SNR points run sequentially against the *same* compiled chunk (the noise
  variance is a traced argument), instead of one pool thread per SNR.
* Within an SNR point, launches of ``chunks_per_launch x batch`` codewords
  are issued until the reference's stopping rules hit:
  ``tot_blk >= maximum_block_number`` or ``err_blk >= maximum_error_number``
  (simulator.cc:117).  The check runs between launches and counts the
  in-flight launch toward the block cap, so fixed-block sweeps stop exactly
  at the cap (rounded up to whole launches); the error-count rule can
  overrun by the one in-flight launch — the same kind of overrun the
  reference's in-flight worker blocks produce (documented divergence:
  launch-granular instead of block-granular).
* BER = err_bit/tot_bit and FER = err_blk/tot_blk over all counted blocks
  (sourcesink.cc:39-46); telemetry lines use the reference's format.
* Counters are checkpointed to JSON after every consumed launch (and the
  point marked done when it completes), so an interrupted sweep resumes
  mid-SNR-point losing at most the one in-flight launch.  Because chunk
  keys are derived from the consumed-launch counter, a resumed sweep
  replays the exact key sequence and lands on bit-identical final
  counters (the reference has no checkpointing — SURVEY.md section 5.4).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..code.ldpc import load_code
from ..config import Config
from ..io.constellation import parse_constellation
from ..utils.logging import SimLogger
from .chain import ChainSpec, ChunkResult, make_chunk_runner, make_multi_point_runner


@dataclasses.dataclass
class SnrResult:
    snr: float
    ber: float
    fer: float
    tot_blk: int
    err_blk: int
    err_bit: int
    tot_bit: int
    wall_s: float
    blocks_per_s: float
    # empirical second moment of per-block bit-error counts (parity.py's
    # clustered-BER z-test); float — see ChunkResult.err_bit_sq
    err_bit_sq: float = 0.0

    def as_row(self) -> dict:
        """The JSON row that tools/parity.py reads."""
        return dict(snr=self.snr, tot_blk=self.tot_blk, err_blk=self.err_blk,
                    err_bit=self.err_bit, tot_bit=self.tot_bit, ber=self.ber,
                    fer=self.fer, blocks_per_s=self.blocks_per_s,
                    err_bit_sq=self.err_bit_sq)


@dataclasses.dataclass
class _Counters:
    tot_blk: int = 0
    err_blk: int = 0
    err_bit: int = 0
    tot_bit: int = 0
    chunks: int = 0
    err_bit_sq: float = 0.0

    @property
    def ber(self) -> float:
        return self.err_bit / self.tot_bit if self.tot_bit else 0.0

    @property
    def fer(self) -> float:
        return self.err_blk / self.tot_blk if self.tot_blk else 0.0

    @staticmethod
    def from_saved(saved: dict) -> "_Counters":
        """Rebuild from one checkpoint point-state dict."""
        return _Counters(
            **{k: saved[k] for k in
               ("tot_blk", "err_blk", "err_bit", "tot_bit", "chunks")},
            err_bit_sq=saved.get("err_bit_sq", 0.0),
        )


class Simulator:
    """Config-driven sweep runner (the reference ``Simulator``'s role)."""

    def __init__(
        self,
        cfg: Config,
        logger: SimLogger | None = None,
        runner_factory=None,
    ) -> None:
        self.cfg = cfg
        self.log = logger or SimLogger(log_dir=None)
        self.code = load_code(cfg.matrix_path())
        self.constellation = parse_constellation(cfg.modem_path())
        self.spec = ChainSpec.from_config(cfg, self.code, self.constellation)
        # Shape the chunk to the request: a smoke config asking for 1 block
        # must not pay for a 1024-codeword chunk.  [tpu].batch = 0 (the
        # default) falls back to [range].thread_block_number — the
        # reference's per-task chunk size (simulator.cc:90-100) — when that
        # is set above its smoke-test default of 1, else to 1024.
        batch = cfg.tpu.batch
        if batch <= 0:
            batch = (
                cfg.range.thread_block_number
                if cfg.range.thread_block_number > 1
                else 1024
            )
        self.batch = max(1, min(batch, cfg.range.maximum_block_number))
        # fold several sub-chunks into one launch, but never ask for more
        # blocks per launch than the whole sweep point needs
        cpl = max(1, min(cfg.tpu.chunks_per_launch,
                         -(-cfg.range.maximum_block_number // self.batch)))
        self.snr_fold = 0
        if cfg.tpu.snr_fold > 1 and (
            self.spec.kmeans_dump or cfg.tpu.model_parallel > 1
        ):
            # Round 5 lifted the histogram and debug_blocks restrictions
            # (the reference runs every SNR point concurrently in ALL
            # modes, simulator.cc:27,35-42 — short many-point histogram
            # sweeps are exactly snr_fold's win case): the folded path
            # demuxes per-point histogram files and per-point debug
            # chatter from the slot axis.  kmeans_dump stays sequential
            # (a first-launch-only .mat export gains nothing from
            # folding), as does model_parallel (the folded runner has no
            # (slot x data x model) formulation).
            raise ValueError(
                "[tpu].snr_fold is incompatible with kmeans_dump_dir and "
                "model_parallel (use the sequential path for those)"
            )
        if runner_factory is not None:
            self.runner = runner_factory(self.spec, self.batch)
        elif cfg.tpu.snr_fold > 1:
            # multi-point launch folding: one dispatch advances several live
            # SNR points (see _simulate_folded); composes with the data
            # mesh when several devices are visible.
            self.snr_fold = max(1, min(cfg.tpu.snr_fold, len(cfg.snr_points())))
            ndev = cfg.tpu.data_parallel or len(jax.devices())
            if ndev > 1 and self.batch >= ndev:
                from ..parallel.sharding import (
                    get_mesh,
                    make_sharded_multi_point_runner,
                )

                self.batch -= self.batch % ndev
                self.runner = make_sharded_multi_point_runner(
                    self.spec, self.batch, get_mesh(ndev), cpl, self.snr_fold
                )
                self.log.info(
                    f"Mesh: {ndev} devices, data-parallel batch {self.batch}; "
                    f"SNR-fold {self.snr_fold} launch slots per dispatch"
                )
            else:
                self.runner = make_multi_point_runner(
                    self.spec, self.batch, cpl, self.snr_fold
                )
                self.log.info(
                    f"SNR-fold: {self.snr_fold} launch slots per dispatch"
                )
        elif cfg.tpu.model_parallel > 1:
            # (data x model) 2-D mesh: front-end data-parallel, final
            # decode's message state row-sharded over the model axis
            # (parallel/edge_sharded.py).
            from ..parallel.edge_sharded import (
                get_mesh_2d,
                make_model_parallel_chunk_runner,
            )

            nmodel = cfg.tpu.model_parallel
            navail = len(jax.devices())
            ndata = cfg.tpu.data_parallel or max(1, navail // nmodel)
            mesh = get_mesh_2d(ndata, nmodel)  # raises if over-subscribed
            self.batch = max(ndata, self.batch - self.batch % ndata)
            self.runner = make_model_parallel_chunk_runner(
                self.spec, self.batch, mesh, cpl
            )
            self.log.info(
                f"Mesh: {ndata} data x {nmodel} model devices, "
                f"batch {self.batch}, decoder row-sharded {nmodel} ways"
            )
        else:
            ndev = cfg.tpu.data_parallel or len(jax.devices())
            if ndev > 1 and self.batch >= ndev:
                from ..parallel.sharding import get_mesh, make_sharded_chunk_runner

                self.batch -= self.batch % ndev  # make divisible
                mesh = get_mesh(ndev)
                self.runner = make_sharded_chunk_runner(self.spec, self.batch, mesh, cpl)
                self.log.info(f"Mesh: {ndev} devices, data-parallel batch {self.batch}")
            else:
                self.runner = make_chunk_runner(self.spec, self.batch, cpl)
        self.root_key = jax.random.key(cfg.tpu.seed)
        self.log.info(
            f"[{cfg.range.minimum_snr:.3f},{cfg.range.step_snr:.3f},{cfg.range.maximum_snr:.3f}]"
        )
        self.log.info(
            f"[MAX_ERROR_BLK = {cfg.range.maximum_error_number},"
            f"MAX_BLK = {cfg.range.maximum_block_number}]"
        )
        kind = "5G LDPC" if self.code.is_5g else "traditional LDPC"
        self.log.info(f"Using {kind}.")

    # -- checkpointing ------------------------------------------------------
    def _ckpt_path(self) -> str:
        return self.cfg.tpu.checkpoint_path

    def _save_ckpt(self, state: dict) -> None:
        path = self._ckpt_path()
        if not path:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)

    def _load_ckpt(self) -> dict:
        path = self._ckpt_path()
        if path and os.path.exists(path):
            with open(path) as f:
                state = json.load(f)
            if state.get("fingerprint") == self._fingerprint():
                return state
            self.log.info("Checkpoint fingerprint mismatch; starting fresh.")
        return {"fingerprint": self._fingerprint(), "snr": {}}

    def _fingerprint(self) -> str:
        c = self.cfg
        # The runner topology is part of the fingerprint: the sharded
        # runners split each launch key over the device mesh, so a
        # checkpoint resumed under a different device count / parallelism
        # layout would silently merge two incompatible RNG streams and
        # break the bit-identical-resume invariant.  Mismatch -> fresh
        # start (with a log line), never a silent mix.
        topology = (
            f"{len(jax.devices())}|{c.tpu.data_parallel}|{c.tpu.snr_fold}|"
            f"{c.tpu.model_parallel}|{c.tpu.chunks_per_launch}"
        )
        return (
            f"{c.ldpc.matrix_file}|{c.modem.modem_file}|{c.ldpc.max_iter}|"
            f"{c.decoder.true_h_arg}|{c.xcodec.ldpc_5g}|{c.xcodec.metric_type}|"
            f"{c.xcodec.metric_iter}|{c.range.maximum_block_number}|"
            f"{c.range.maximum_error_number}|{self.batch}|{topology}"
        )

    # -- main loop ----------------------------------------------------------
    def run_snr_point(
        self,
        snr: float,
        counters: _Counters | None = None,
        histogram_file=None,
        save_partial=None,
    ) -> SnrResult:
        cfg = self.cfg
        var = 10.0 ** (-0.1 * snr)  # simulator.cc:74 — no rate normalization
        c = counters or _Counters()
        t0 = time.monotonic()
        max_blk = cfg.range.maximum_block_number
        max_err = cfg.range.maximum_error_number
        # fold_in rejects negative data; mask to uint32 (negative SNRs).
        key = jax.random.fold_in(self.root_key, int(round(snr * 1000)) & 0xFFFFFFFF)
        last_print = c.tot_blk
        km_dump_pending = bool(cfg.tpu.kmeans_dump_dir) and self.spec.kmeans_dump
        debug_pending = self.spec.debug_blocks > 0

        # Double-buffered dispatch: launch chunk k before reading chunk
        # k-1's counters, so the host's readback and bookkeeping overlap the
        # next chunk's compute.  The stop condition therefore lags one chunk — the same
        # chunk-granular overrun already documented above.
        def consume(res: ChunkResult) -> None:
            nonlocal last_print, km_dump_pending, debug_pending
            if km_dump_pending and res.kmeans_diag:
                self._dump_kmeans(snr, res)
                km_dump_pending = False  # first launch of the point only
            if debug_pending and res.debug:
                self._log_debug_blocks(res, c.tot_blk)
                debug_pending = False  # first launch of the point only
            c.chunks += 1  # consumed launches — the checkpoint/resume cursor
            c.err_bit += int(res.err_bit)
            c.err_blk += int(res.err_blk)
            c.tot_bit += int(res.tot_bit)
            c.tot_blk += int(res.tot_blk)
            c.err_bit_sq += float(res.err_bit_sq)
            if histogram_file is not None:
                self._write_histogram(histogram_file, np.asarray(res.metrics))
            # per-chunk chatter goes to the log file only, like the
            # reference's per-block lines (simulator.cc:124-126)
            self.log.info(
                f"chunk {c.chunks}: mean BP iters = {float(res.iters):.2f}",
                to_stdout=False,
            )
            # reference prints every 100 blocks (simulator.cc:167)
            if c.tot_blk - last_print >= 100 or c.tot_blk >= max_blk or c.err_blk >= max_err:
                self._print_result(snr, c)
                last_print = c.tot_blk
            if save_partial is not None:
                save_partial(c)

        # count the not-yet-consumed in-flight launch toward the block cap,
        # so a fixed-block sweep does not over-launch a whole extra chunk.
        # `launched` leads `c.chunks` (consumed) by the in-flight launch;
        # chunk keys fold in the launch index, so a resume from a mid-point
        # checkpoint (c.chunks consumed launches) re-issues the lost
        # in-flight launch under its original key — bit-identical to an
        # uninterrupted sweep.
        per_launch = getattr(self.runner, "blocks_per_launch", self.batch)
        launched = c.chunks
        pending: ChunkResult | None = None
        while (
            c.tot_blk + (per_launch if pending is not None else 0) < max_blk
            and c.err_blk < max_err
        ):
            chunk_key = jax.random.fold_in(key, launched)
            res: ChunkResult = self.runner(chunk_key, np.float32(var))
            launched += 1
            if pending is not None:
                consume(pending)
            pending = res
        if pending is not None:
            consume(pending)
        wall = time.monotonic() - t0
        self._print_result(snr, c)
        return SnrResult(
            snr=snr, ber=c.ber, fer=c.fer, tot_blk=c.tot_blk, err_blk=c.err_blk,
            err_bit=c.err_bit, tot_bit=c.tot_bit, wall_s=wall,
            blocks_per_s=c.tot_blk / wall if wall > 0 else 0.0,
            err_bit_sq=c.err_bit_sq,
        )

    def _dump_kmeans(self, snr: float, res: ChunkResult) -> None:
        """Write per-block k-means diagnostics (KMeans::DumpToMat parity,
        kmeans.cc:96-111): received symbols, final clusters, per-symbol
        assignments, constellation, the 4 hhat candidates, and the true h,
        under the reference's variable names (records.dump_kmeans)."""
        from ..utils.records import dump_kmeans

        d = self.cfg.tpu.kmeans_dump_dir
        os.makedirs(d, exist_ok=True)
        yr, yi, cl_r, cl_i, idx, h4_r, h4_i, hr_t, hi_t = (
            np.asarray(a) for a in res.kmeans_diag
        )
        const = self.constellation.points
        nb = min(self.cfg.tpu.kmeans_dump_blocks, yr.shape[0])
        for j in range(nb):
            dump_kmeans(
                os.path.join(d, f"kmeans_snr{snr:.3f}_blk{j}"),
                yr[j] + 1j * yi[j],
                cl_r[j] + 1j * cl_i[j],
                idx[j],
                const,
                h4_r[j] + 1j * h4_i[j],
                complex(hr_t[j], hi_t[j]),
            )
        self.log.info(
            f"k-means diagnostics: wrote {nb} blocks to {d}", to_stdout=False
        )

    def _log_debug_blocks(
        self, res: ChunkResult, tot_before: int, slot: int | None = None
    ) -> None:
        """Per-block debug chatter, logfile only ([tpu].debug_blocks).

        Replicates the reference's per-block lines and formats:
        ``Generated H = (re,im)`` (simulator.cc:124-126, std::complex
        operator<< at default 6-significant-digit precision), and in blind
        mode ``Current Block Number = NNNNNNN`` (simulator.cc:149-152),
        one ``Hhat = (re,im) Metric = v`` per candidate at fixed precision
        14 with the PRE-abs metric value (kmcodec.cc:132-140: the line is
        printed before std::abs; soft metrics are log-sums <= 0, so
        pre-abs = -|metric| there), and ``hatIndex = k``
        (kmcodec.cc:64).

        ``slot`` selects one launch slot of a folded dispatch (the
        ChunkResult arrays carry a leading [m] axis there); None for the
        sequential path's unstacked result.
        """
        sel = (lambda a: np.asarray(a)[slot]) if slot is not None else np.asarray
        nblk = int(sel(res.tot_blk))
        n = min(self.spec.debug_blocks, nblk)
        hr_t = sel(res.debug[0])
        hi_t = sel(res.debug[1])
        blind = len(res.debug) > 2
        if blind:
            h4_r = sel(res.debug[2])
            h4_i = sel(res.debug[3])
            metrics = sel(res.metrics)
            pre = -metrics if self.spec.metric_type else metrics
        for j in range(min(n, hr_t.shape[0])):
            self.log.info(
                f"Generated H = ({hr_t[j]:g},{hi_t[j]:g})", to_stdout=False
            )
            if not blind:
                continue
            self.log.info(
                f"Current Block Number = {tot_before + j + 1:07d}",
                to_stdout=False,
            )
            for k in range(4):
                self.log.info(
                    f"Hhat = ({h4_r[j, k]:.14f},{h4_i[j, k]:.14f}) "
                    f"Metric = {pre[j, k]:.14f}",
                    to_stdout=False,
                )
            self.log.info(
                f"hatIndex = {int(np.argmin(metrics[j]))}", to_stdout=False
            )

    def _print_result(self, snr: float, c: _Counters) -> None:
        # sourcesink.cc:49-65 format
        self.log.info(
            f"SNR = {snr:.3f} Total blk = {c.tot_blk:7d} "
            f"Error blk = {c.err_blk:7d} Error bit = {c.err_bit:7d} "
            f"BER = {c.ber:.14f} FER = {c.fer:.14f}"
        )

    @staticmethod
    def _write_histogram(f, metrics: np.ndarray) -> None:
        """Rotated metric rows: minimum first (simulator.cc:154-163).

        NaN columns mark absent candidates (known-h mode has a single
        candidate) and are dropped, like the reference's 1-element rows.
        """
        for row in metrics:
            row = row[np.isfinite(row)]
            k = int(row.argmin()) if row.size else 0
            rolled = np.roll(row, -k)
            f.write(" ".join(f"{v:g}" for v in rolled) + " \n")

    def simulate(self) -> list[SnrResult]:
        body = self._simulate_folded if self.snr_fold else self._simulate
        if self.cfg.tpu.profile_dir:
            import jax.profiler

            with jax.profiler.trace(self.cfg.tpu.profile_dir):
                return body()
        return body()

    def _simulate_folded(self) -> list[SnrResult]:
        """Concurrent SNR points: one dispatch carries ``snr_fold`` whole
        launches round-robined over the LIVE points.

        The batched analogue of the reference's one-pool-thread-per-SNR-point
        outer concurrency (simulator.cc:27,35-42).  Each slot is exactly
        one sequential-path launch — same key derivation
        (fold_in(point_key, launch_index)), same chunk program — so a
        block-capped sweep lands on bit-identical per-point counters; the
        error-cap rule sees counters that lag by the in-flight slots
        instead of by one launch (the same launch-granular divergence
        documented for the sequential path, just deeper).  Dead slots pad
        the last dispatches to the fixed shape; their results are
        discarded on the host, preserving the per-point launch sequence.
        """
        cfg = self.cfg
        state = self._load_ckpt()
        m = self.snr_fold
        per_launch = self.runner.blocks_per_launch
        max_blk = cfg.range.maximum_block_number
        max_err = cfg.range.maximum_error_number
        t0 = time.monotonic()

        points = cfg.snr_points()
        cs: dict[float, _Counters] = {}
        done: dict[float, bool] = {}
        launched: dict[float, int] = {}
        inflight: dict[float, int] = {}
        pkeys: dict[float, jax.Array] = {}
        last_print: dict[float, int] = {}
        blk0: dict[float, int] = {}  # blocks already done before this run
        # per-point wall attribution: each consume's wall delta is split
        # evenly over the dispatch's valid slots and charged to their
        # points, so folded per-point wall_s/blocks_per_s sum to the run's
        # compute span and stay comparable with sequential sweeps
        # (round 5; previously the aggregate rate was replicated onto
        # every point).  t_mark advances at every consume.
        wall_attr: dict[float, float] = {}
        t_mark = t0
        # per-point histogram files, demuxed from the slot axis
        # (simulator.cc:91-94's per-point files; the folded analogue) —
        # opened lazily on the point's first consumed slot
        hist_files: dict[float, object] = {}
        debug_pending: dict[float, bool] = {}
        for snr in points:
            saved = state["snr"].get(f"{snr:.3f}")
            c = _Counters.from_saved(saved) if saved else _Counters()
            cs[snr] = c
            blk0[snr] = c.tot_blk
            done[snr] = bool(saved and saved.get("done"))
            launched[snr] = c.chunks
            inflight[snr] = 0
            last_print[snr] = c.tot_blk
            wall_attr[snr] = 0.0
            debug_pending[snr] = self.spec.debug_blocks > 0
            pkeys[snr] = jax.random.fold_in(
                self.root_key, int(round(snr * 1000)) & 0xFFFFFFFF
            )
            if saved and not done[snr]:
                self.log.info(
                    f"SNR {snr:.3f}: resuming mid-point from checkpoint "
                    f"({c.tot_blk} blocks done)"
                )

        def wants(snr: float) -> bool:
            c = cs[snr]
            return (
                not done[snr]
                and c.tot_blk + per_launch * inflight[snr] < max_blk
                and c.err_blk < max_err
            )

        def save_point(snr: float) -> None:
            c = cs[snr]
            state["snr"][f"{snr:.3f}"] = dict(
                tot_blk=c.tot_blk, err_blk=c.err_blk, err_bit=c.err_bit,
                tot_bit=c.tot_bit, chunks=c.chunks, done=done[snr],
                err_bit_sq=c.err_bit_sq,
            )

        def consume(dispatch) -> None:
            nonlocal t_mark
            slots, res = dispatch
            err_bit = np.asarray(res.err_bit)
            err_blk = np.asarray(res.err_blk)
            tot_bit = np.asarray(res.tot_bit)
            tot_blk = np.asarray(res.tot_blk)
            err_sq = np.asarray(res.err_bit_sq)
            iters = np.asarray(res.iters)
            now = time.monotonic()
            n_valid = sum(1 for _, v in slots if v)
            dt_slot = (now - t_mark) / n_valid if n_valid else 0.0
            t_mark = now
            for j, (snr, valid) in enumerate(slots):
                if not valid:
                    # dead padding slot — discard; it never incremented
                    # inflight (decrementing here drove inflight negative,
                    # which re-opened capped points via wants() and made
                    # the dispatch loop run away — caught in round-4
                    # review, regression-tested below)
                    continue
                inflight[snr] -= 1
                wall_attr[snr] += dt_slot
                c = cs[snr]
                c.chunks += 1
                c.err_bit += int(err_bit[j])
                c.err_blk += int(err_blk[j])
                c.tot_bit += int(tot_bit[j])
                c.tot_blk += int(tot_blk[j])
                c.err_bit_sq += float(err_sq[j])
                if cfg.histogram.enable:
                    f = hist_files.get(snr)
                    if f is None:
                        f = hist_files[snr] = open(
                            f"histogram_{snr:.6f}.txt", "w"
                        )
                    self._write_histogram(f, np.asarray(res.metrics[j]))
                if debug_pending[snr] and res.debug:
                    # first consumed launch of the point only, like the
                    # sequential path
                    self._log_debug_blocks(
                        res, c.tot_blk - int(tot_blk[j]), slot=j
                    )
                    debug_pending[snr] = False
                self.log.info(
                    f"chunk {c.chunks} [snr {snr:.3f}]: "
                    f"mean BP iters = {float(iters[j]):.2f}",
                    to_stdout=False,
                )
                if (c.tot_blk - last_print[snr] >= 100 or c.tot_blk >= max_blk
                        or c.err_blk >= max_err):
                    self._print_result(snr, c)
                    last_print[snr] = c.tot_blk
                if self._ckpt_path():
                    save_point(snr)
            if self._ckpt_path():
                self._save_ckpt(state)

        rr = 0  # round-robin cursor over points
        pending: list = []
        try:
            while True:
                # assemble the next dispatch: m slots round-robined over
                # the points that still want a launch (a point may take
                # several slots — consecutive launch indices — when few
                # points remain)
                slots: list[tuple[float, bool]] = []
                keys, vars_ = [], []
                while len(slots) < m and any(wants(p) for p in points):
                    snr = points[rr % len(points)]
                    rr += 1
                    if not wants(snr):
                        continue
                    slots.append((snr, True))
                    keys.append(jax.random.fold_in(pkeys[snr], launched[snr]))
                    vars_.append(10.0 ** (-0.1 * snr))
                    launched[snr] += 1
                    inflight[snr] += 1
                if not slots:
                    if pending:
                        consume(pending.pop(0))
                        continue
                    break
                while len(slots) < m:  # dead padding, discarded on consume
                    slots.append((slots[0][0], False))
                    keys.append(keys[0])
                    vars_.append(vars_[0])
                res = self.runner(jnp.stack(keys), np.asarray(vars_, np.float32))
                pending.append((slots, res))
                if len(pending) > 1:  # double-buffered: consume the older one
                    consume(pending.pop(0))
        finally:
            # per-point histogram files survive an interrupted sweep with
            # whatever launches were consumed (the sequential path's
            # try/finally equivalent)
            for f in hist_files.values():
                f.close()
        # Per-point wall attribution (round 5): every consume charged its
        # wall delta to the slots it carried, so the per-point wall_s sum
        # to the run's compute span (t0 .. last consume) and the per-point
        # blocks_per_s are comparable with sequential sweep logs.  The
        # first dispatch's delta includes compile/warmup, like the
        # sequential path's first launch does.  Points fully restored from
        # the checkpoint report 0/0 like the sequential path does.

        results: list[SnrResult] = []
        for snr in points:
            c = cs[snr]
            restored = done[snr]
            done[snr] = True
            save_point(snr)
            self._print_result(snr, c)
            w = wall_attr[snr]
            run_blocks = c.tot_blk - blk0[snr]
            results.append(SnrResult(
                snr=snr, ber=c.ber, fer=c.fer, tot_blk=c.tot_blk,
                err_blk=c.err_blk, err_bit=c.err_bit, tot_bit=c.tot_bit,
                wall_s=0.0 if restored else w,
                blocks_per_s=(
                    0.0 if restored or w <= 0 else run_blocks / w
                ),
                err_bit_sq=c.err_bit_sq,
            ))
        if self._ckpt_path():
            self._save_ckpt(state)
        self._print_tables(results)
        return results

    def _print_tables(self, results: list[SnrResult]) -> None:
        # final tables (simulator.cc:43-66)
        self.log.info("BER Result")
        for r in results:
            self.log.info(f"{r.snr:.3f} {r.ber:.14f}")
        self.log.info("FER Result")
        for r in results:
            self.log.info(f"{r.snr:.3f} {r.fer:.14f}")

    def _simulate(self) -> list[SnrResult]:
        cfg = self.cfg
        state = self._load_ckpt()
        results: list[SnrResult] = []
        for snr in cfg.snr_points():
            snr_key = f"{snr:.3f}"
            saved = state["snr"].get(snr_key)
            if saved and saved.get("done"):
                c = _Counters.from_saved(saved)
                self.log.info(f"SNR {snr_key}: restored from checkpoint")
                results.append(SnrResult(
                    snr=snr, ber=c.ber, fer=c.fer, tot_blk=c.tot_blk,
                    err_blk=c.err_blk, err_bit=c.err_bit, tot_bit=c.tot_bit,
                    wall_s=0.0, blocks_per_s=0.0, err_bit_sq=c.err_bit_sq,
                ))
                continue
            c = _Counters.from_saved(saved) if saved else _Counters()
            if saved:
                self.log.info(
                    f"SNR {snr_key}: resuming mid-point from checkpoint "
                    f"({c.tot_blk} blocks done)"
                )

            def save_partial(cc, _snr_key=snr_key):
                # mid-point checkpoint: one consumed launch at most is lost
                # on interruption (the in-flight one); chunk keys fold in
                # cc.chunks so the resumed sequence is bit-identical
                state["snr"][_snr_key] = dict(
                    tot_blk=cc.tot_blk, err_blk=cc.err_blk, err_bit=cc.err_bit,
                    tot_bit=cc.tot_bit, chunks=cc.chunks, done=False,
                    err_bit_sq=cc.err_bit_sq,
                )
                self._save_ckpt(state)

            hist_f = None
            if cfg.histogram.enable:
                hist_f = open(f"histogram_{snr:.6f}.txt", "w")
            try:
                r = self.run_snr_point(
                    snr, c, hist_f,
                    save_partial=save_partial if self._ckpt_path() else None,
                )
            finally:
                if hist_f is not None:
                    hist_f.close()
            results.append(r)
            state["snr"][snr_key] = dict(
                tot_blk=c.tot_blk, err_blk=c.err_blk, err_bit=c.err_bit,
                tot_bit=c.tot_bit, chunks=c.chunks, done=True,
                err_bit_sq=c.err_bit_sq,
            )
            self._save_ckpt(state)
        self._print_tables(results)
        return results
