"""Monte-Carlo harness tests: chain, stopping rules, checkpoint, histogram, CLI."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from kmldpc_tpu.config import Config, load_config
from kmldpc_tpu.sim import Simulator
from kmldpc_tpu.sim.chain import ChainSpec, make_chunk_runner
from kmldpc_tpu.code import load_code
from kmldpc_tpu.io import parse_constellation
from kmldpc_tpu.utils.logging import SimLogger

import dataclasses


def _cfg(assets, **over) -> Config:
    cfg = load_config(str(assets / "config.toml"))
    rng = over.pop("range", {})
    if rng:
        cfg = dataclasses.replace(cfg, range=dataclasses.replace(cfg.range, **rng))
    for section, kv in over.items():
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(getattr(cfg, section), **kv)}
        )
    return cfg


def test_config_load_reference_schema(assets):
    cfg = load_config(str(assets / "config.toml"))
    assert cfg.range.minimum_snr == 15.0
    assert cfg.ldpc.matrix_file == "PEG2304regular0.5.txt"
    assert not cfg.xcodec.ldpc_5g
    assert cfg.snr_points() == [15.0]
    assert os.path.exists(cfg.matrix_path())


def test_config_rejects_unknown_keys_and_tables():
    """A typo'd knob must fail loudly, not silently revert to its default.

    The reference fails on missing keys (toml::find throws); we match that
    spirit for unknown keys/tables in every one of the seven tables.
    """
    from kmldpc_tpu.config import ConfigError, config_from_dict

    # Typo in the table that controls the whole perf/parity surface.
    with pytest.raises(ConfigError, match=r"scheduel.*\[tpu\].*schedule"):
        config_from_dict({"tpu": {"scheduel": "layered-minsum"}})
    with pytest.raises(ConfigError, match=r"phase_1_iters"):
        config_from_dict({"tpu": {"phase_1_iters": 5}})
    with pytest.raises(ConfigError, match=r"\[range\]"):
        config_from_dict({"range": {"min_snr": 10.0}})
    # Unknown top-level table.
    with pytest.raises(ConfigError, match="unknown table"):
        config_from_dict({"rnage": {}})
    # The error message lists the user-facing spelling of renamed keys.
    with pytest.raises(ConfigError, match="5gldpc"):
        config_from_dict({"xcodec": {"bogus": 1}})
    # The reference spelling itself still loads.
    cfg = config_from_dict({"xcodec": {"5gldpc": True}})
    assert cfg.xcodec.ldpc_5g


def test_chunk_runner_known_h_high_snr(assets):
    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    spec = ChainSpec(
        code=code, constellation=const, known_h=True, fading=True,
        metric_type=False, metric_iter=5, max_iter=50,
        encoder_active=True, histogram=False,
    )
    run = make_chunk_runner(spec, batch=16)
    res = run(jax.random.key(0), np.float32(10 ** (-1.8)))  # 18 dB
    assert int(res.tot_blk) == 16
    assert int(res.tot_bit) == 16 * code.code_dim
    assert int(res.err_blk) == 0
    assert int(res.err_bit) == 0


def test_chunk_runner_blind_16qam(assets):
    """Blind detection end-to-end: 16QAM resolves all rotations, so at high
    SNR the blind chain must match the known-h chain (zero errors)."""
    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    spec = ChainSpec(
        code=code, constellation=const, known_h=False, fading=True,
        metric_type=False, metric_iter=5, max_iter=50,
        encoder_active=True, histogram=False,
    )
    run = make_chunk_runner(spec, batch=16)
    res = run(jax.random.key(3), np.float32(10 ** (-2.4)))  # 24 dB
    assert int(res.err_blk) == 0, (int(res.err_blk), int(res.err_bit))


def test_metric_prune_matches_full_selection(assets):
    """[tpu].metric_prune skips the exactly-tied complement candidates:
    on QPSK + PEG2304 (complement-closed, even rows) the pruned chain must
    produce the same counters as the full 4-candidate chain at fixed
    seeds (first-minimum tie-breaking never selects the skipped pair)."""
    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    base = dict(
        code=code, constellation=const, known_h=False, fading=True,
        metric_type=False, metric_iter=5, max_iter=50,
        encoder_active=True, histogram=False,
    )
    key = jax.random.key(9)
    var = np.float32(10 ** (-1.2))  # 12 dB: mix of clean and erroring blocks
    full = make_chunk_runner(ChainSpec(**base), batch=32)(key, var)
    pruned = make_chunk_runner(
        ChainSpec(**base, metric_prune=True), batch=32
    )(key, var)
    assert int(pruned.tot_blk) == int(full.tot_blk) == 32
    assert int(pruned.err_blk) == int(full.err_blk)
    assert int(pruned.err_bit) == int(full.err_bit)
    # the reported metric table duplicates the tied pairs
    m = np.asarray(pruned.metrics)
    np.testing.assert_array_equal(m[:, :2], m[:, 2:])
    np.testing.assert_array_equal(m[:, :2], np.asarray(full.metrics)[:, :2])


def test_metric_prune_validation(assets):
    """Pruning requires the exact-tie conditions; 16QAM Gray (negation is
    not label-complementing) must be rejected with a named error, as must
    histogram mode."""
    import dataclasses as dc

    from kmldpc_tpu.detect.metric import complement_closed
    from kmldpc_tpu.sim.chain import build_chain_fn

    peg = load_code(str(assets / "PEG2304regular0.5.txt"))
    qpsk = parse_constellation(str(assets / "2bits_QPSK.txt"))
    qam = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    assert complement_closed(peg, qpsk)
    assert not complement_closed(peg, qam)
    # a >4-point table is rejected even when mathematically closed: with
    # more than 2 points per demap bit class the f32 logsumexp permutation
    # can differ by an ulp, so the exact-tie guarantee pruning relies on
    # does not hold (round-4 advisor finding).  8-PSK with label(k+4) =
    # ~label(k) is negation-closed with complemented labels by design.
    import numpy as _np

    from kmldpc_tpu.io.constellation import Constellation

    pts = _np.exp(1j * _np.pi / 4 * _np.arange(8))
    labels = _np.array([0, 1, 2, 3, 7, 6, 5, 4])
    bits8 = ((labels[:, None] >> _np.arange(2, -1, -1)) & 1).astype(_np.int8)
    psk8 = Constellation(bits_per_symbol=3, points=pts, bits=bits8)
    assert not complement_closed(peg, psk8)
    spec = ChainSpec(
        code=peg, constellation=qam, known_h=False, fading=True,
        metric_type=False, metric_iter=5, max_iter=50,
        encoder_active=True, histogram=False, metric_prune=True,
    )
    with pytest.raises(ValueError, match="complement-closed"):
        build_chain_fn(spec, 8)
    hist = dc.replace(spec, constellation=qpsk, histogram=True)
    with pytest.raises(ValueError, match="histogram"):
        build_chain_fn(hist, 8)


def test_debug_blocks_chatter(assets, tmp_path):
    """[tpu].debug_blocks logs the reference's per-block lines (file only):
    Generated H, Current Block Number, per-candidate Hhat/Metric, hatIndex
    (simulator.cc:124-126,149-152; kmcodec.cc:64,132-137)."""
    import re

    cfg = _cfg(
        assets,
        range=dict(maximum_block_number=8, maximum_error_number=10**9),
        decoder=dict(true_h_arg=False),
        tpu=dict(batch=8, chunks_per_launch=1, data_parallel=1, debug_blocks=3),
    )
    log = SimLogger(log_dir=str(tmp_path), stdout=False)
    Simulator(cfg, log).run_snr_point(24.0)
    log.close()
    text = open(log._path).read()
    assert len(re.findall(r"Generated H = \(-?\d[^,]*,-?\d[^)]*\)", text)) == 3
    assert "Current Block Number = 0000001" in text
    assert len(re.findall(
        r"Hhat = \(-?\d+\.\d{14},-?\d+\.\d{14}\) Metric = -?\d+\.\d{14}", text
    )) == 12  # 3 blocks x 4 candidates
    assert len(re.findall(r"hatIndex = [0-3]", text)) == 3


def test_multi_point_runner_slots_match_sequential_launches(assets):
    """Each slot of the multi-point runner is bit-identical to the same
    (key, var) launch through make_chunk_runner — the invariant the folded
    SNR sweep relies on."""
    import jax.numpy as jnp

    from kmldpc_tpu.sim.chain import make_multi_point_runner

    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    spec = ChainSpec(
        code=code, constellation=const, known_h=True, fading=True,
        metric_type=False, metric_iter=5, max_iter=30,
        encoder_active=True, histogram=False,
    )
    seq = make_chunk_runner(spec, 8, chunks_per_launch=2)
    multi = make_multi_point_runner(spec, 8, chunks_per_launch=2, m=3)
    keys = [jax.random.key(i) for i in (5, 6, 7)]
    vars_ = [10 ** (-0.3), 10 ** (-0.3), 10 ** (-0.8)]
    res = multi(jnp.stack(keys), vars_)
    for j in range(3):
        r = seq(keys[j], np.float32(vars_[j]))
        for field in ("err_bit", "err_blk", "tot_bit", "tot_blk"):
            assert int(getattr(res, field)[j]) == int(getattr(r, field)), field
        assert float(res.err_bit_sq[j]) == float(r.err_bit_sq)


def test_snr_fold_bit_identical_sweep(assets):
    """[tpu].snr_fold: a block-capped multi-point sweep lands on
    bit-identical per-point counters vs the sequential path (VERDICT r3
    item 7 'done' criterion), at fixed seeds."""
    common = dict(
        range=dict(minimum_snr=2.0, maximum_snr=6.0, step_snr=2.0,
                   maximum_block_number=48, maximum_error_number=10**9),
        decoder=dict(true_h_arg=True),
    )
    cfg_seq = _cfg(assets, tpu=dict(batch=8, chunks_per_launch=2,
                                    data_parallel=1), **common)
    cfg_fold = _cfg(assets, tpu=dict(batch=8, chunks_per_launch=2,
                                     data_parallel=1, snr_fold=3), **common)
    r_seq = Simulator(cfg_seq, SimLogger(log_dir=None, stdout=False)).simulate()
    r_fold = Simulator(cfg_fold, SimLogger(log_dir=None, stdout=False)).simulate()
    assert len(r_seq) == len(r_fold) == 3
    for a, b in zip(r_seq, r_fold):
        assert a.snr == b.snr
        assert (a.tot_blk, a.err_blk, a.err_bit, a.tot_bit) == \
               (b.tot_blk, b.err_blk, b.err_bit, b.tot_bit), a.snr
        assert a.err_bit_sq == b.err_bit_sq


def test_snr_fold_composes_with_data_mesh(assets):
    """snr_fold over a data-parallel mesh: a block-capped sweep lands on
    bit-identical per-point counters vs the sequential SHARDED path (each
    slot splits its launch key over the devices exactly the same way)."""
    common = dict(
        range=dict(minimum_snr=2.0, maximum_snr=6.0, step_snr=2.0,
                   maximum_block_number=32, maximum_error_number=10**9),
        decoder=dict(true_h_arg=True),
    )
    cfg_seq = _cfg(assets, tpu=dict(batch=16, chunks_per_launch=2,
                                    data_parallel=2), **common)
    cfg_fold = _cfg(assets, tpu=dict(batch=16, chunks_per_launch=2,
                                     data_parallel=2, snr_fold=3), **common)
    r_seq = Simulator(cfg_seq, SimLogger(log_dir=None, stdout=False)).simulate()
    r_fold = Simulator(cfg_fold, SimLogger(log_dir=None, stdout=False)).simulate()
    for a, b in zip(r_seq, r_fold):
        assert (a.snr, a.tot_blk, a.err_blk, a.err_bit, a.tot_bit) == \
               (b.snr, b.tot_blk, b.err_blk, b.err_bit, b.tot_bit), a.snr


def test_snr_fold_non_divisible_padding_terminates(assets):
    """Regression (round-4 review): when the total launch count is not a
    multiple of the fold, the padded dead slots must not perturb the
    in-flight accounting.  The old code decremented `inflight` for dead
    slots that never incremented it, driving it negative — wants()
    re-opened capped points and the dispatch loop ran away forever.
    3 points x 3 launches with snr_fold=2 forces padding; the sweep must
    terminate at the cap with counters bit-identical to sequential."""
    common = dict(
        range=dict(minimum_snr=2.0, maximum_snr=6.0, step_snr=2.0,
                   maximum_block_number=24, maximum_error_number=10**9),
        decoder=dict(true_h_arg=True),
    )
    cfg_seq = _cfg(assets, tpu=dict(batch=8, chunks_per_launch=1,
                                    data_parallel=1), **common)
    cfg_fold = _cfg(assets, tpu=dict(batch=8, chunks_per_launch=1,
                                     data_parallel=1, snr_fold=2), **common)
    r_seq = Simulator(cfg_seq, SimLogger(log_dir=None, stdout=False)).simulate()
    r_fold = Simulator(cfg_fold, SimLogger(log_dir=None, stdout=False)).simulate()
    for a, b in zip(r_seq, r_fold):
        assert a.tot_blk == b.tot_blk == 24, (a.snr, a.tot_blk, b.tot_blk)
        assert (a.err_blk, a.err_bit) == (b.err_blk, b.err_bit), a.snr


def test_snr_fold_rejects_kmeans_dump_and_model_parallel(assets):
    """histogram and debug_blocks fold since round 5 (the reference runs
    every SNR point concurrently in ALL modes, simulator.cc:35-42); the
    remaining sequential-only diagnostics are kmeans_dump and
    model_parallel."""
    cfg = _cfg(assets, decoder=dict(true_h_arg=False),
               tpu=dict(snr_fold=2, kmeans_dump_dir="/tmp/x"))
    with pytest.raises(ValueError, match="kmeans_dump"):
        Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    cfg = _cfg(assets, tpu=dict(snr_fold=2, model_parallel=2))
    with pytest.raises(ValueError, match="model_parallel"):
        Simulator(cfg, SimLogger(log_dir=None, stdout=False))


@pytest.mark.parametrize("dp", [1, 2])
def test_snr_fold_histogram_byte_identical(assets, tmp_path, monkeypatch, dp):
    """Folded histogram sweeps (allowed since round 5 — short many-point
    histogram sweeps are exactly snr_fold's win case) demux per-point
    histogram files from the slot axis, BYTE-identical to the sequential
    path's files at fixed seeds (per-point launch order is preserved by
    the round-robin assembly + FIFO consume).  dp=2 composes the fold
    with the data mesh (the sharded multi-point runner's slot-major
    metrics layout)."""
    common = dict(
        range=dict(minimum_snr=16.0, maximum_snr=24.0, step_snr=4.0,
                   maximum_block_number=24, maximum_error_number=10**9),
        decoder=dict(true_h_arg=False),
        histogram=dict(enable=True),
    )
    seq_dir = tmp_path / "seq"
    fold_dir = tmp_path / "fold"
    seq_dir.mkdir()
    fold_dir.mkdir()
    monkeypatch.chdir(seq_dir)
    cfg = _cfg(assets, tpu=dict(batch=8, chunks_per_launch=1,
                                data_parallel=dp), **common)
    Simulator(cfg, SimLogger(log_dir=None, stdout=False)).simulate()
    monkeypatch.chdir(fold_dir)
    cfgf = _cfg(assets, tpu=dict(batch=8, chunks_per_launch=1,
                                 data_parallel=dp, snr_fold=3), **common)
    rs = Simulator(cfgf, SimLogger(log_dir=None, stdout=False)).simulate()
    seq_files = sorted(os.listdir(seq_dir))
    fold_files = sorted(os.listdir(fold_dir))
    assert seq_files == fold_files and len(seq_files) == 3
    for f in seq_files:
        assert (seq_dir / f).read_bytes() == (fold_dir / f).read_bytes(), f
    # per-point wall attribution: wall_s > 0 for every computed point and
    # blocks_per_s * wall_s reproduces the point's computed blocks
    for r in rs:
        assert r.wall_s > 0
        assert abs(r.blocks_per_s * r.wall_s - r.tot_blk) < 1e-6


def test_snr_fold_debug_blocks_matches_sequential(assets, tmp_path):
    """Folded debug_blocks chatter (allowed since round 5): the per-block
    logfile lines of each point's FIRST launch match the sequential
    path's lines exactly at fixed seeds."""
    import re

    common = dict(
        range=dict(minimum_snr=20.0, maximum_snr=24.0, step_snr=4.0,
                   maximum_block_number=16, maximum_error_number=10**9),
        decoder=dict(true_h_arg=False),
    )

    def debug_lines(log_dir, fold):
        tpu = dict(batch=8, chunks_per_launch=1, data_parallel=1,
                   debug_blocks=2)
        if fold:
            tpu["snr_fold"] = 2
        cfg = _cfg(assets, tpu=tpu, **common)
        log = SimLogger(log_dir=str(log_dir), stdout=False)
        Simulator(cfg, log).simulate()
        log.close()
        text = open(log._path).read()
        pat = re.compile(
            r"(Generated H = .*|Current Block Number = .*|Hhat = .*|"
            r"hatIndex = .*)$"
        )
        return [m.group(1) for m in map(pat.search, text.splitlines()) if m]

    seq = debug_lines(tmp_path / "seq", fold=False)
    fold = debug_lines(tmp_path / "fold", fold=True)
    assert seq and seq == fold


def test_snr_fold_wall_attribution_sums_to_run_wall(assets):
    """Round 5: folded sweeps attribute wall clock per point (each
    consume's delta split over its valid slots) instead of replicating
    the aggregate rate.  The per-point wall_s must sum to the run's
    compute span (<= total elapsed, and the dominant share of it)."""
    import time as _time

    cfg = _cfg(
        assets,
        range=dict(minimum_snr=2.0, maximum_snr=6.0, step_snr=2.0,
                   maximum_block_number=32, maximum_error_number=10**9),
        decoder=dict(true_h_arg=True),
        tpu=dict(batch=8, chunks_per_launch=1, data_parallel=1, snr_fold=3),
    )
    t0 = _time.monotonic()
    rs = Simulator(cfg, SimLogger(log_dir=None, stdout=False)).simulate()
    elapsed = _time.monotonic() - t0
    total = sum(r.wall_s for r in rs)
    assert all(r.wall_s > 0 for r in rs)
    assert total <= elapsed
    # Simulator construction is outside simulate(); the compute span still
    # dominates the loop's non-consume tail (final prints)
    assert total > 0.2 * elapsed
    for r in rs:
        assert abs(r.blocks_per_s * r.wall_s - r.tot_blk) < 1e-6


def test_snr_fold_error_cap_terminates(assets):
    """The error-cap stopping rule terminates the folded sweep (with the
    documented in-flight-slots overrun, launch-granular)."""
    cfg = _cfg(
        assets,
        range=dict(minimum_snr=0.0, maximum_snr=2.0, step_snr=2.0,
                   maximum_block_number=10**6, maximum_error_number=4),
        decoder=dict(true_h_arg=True),
        tpu=dict(batch=8, chunks_per_launch=1, data_parallel=1, snr_fold=2),
    )
    rs = Simulator(cfg, SimLogger(log_dir=None, stdout=False)).simulate()
    for r in rs:
        assert r.err_blk >= 4
        assert r.tot_blk <= 8 * 8  # bounded overrun


def test_stopping_rule_max_blocks(assets, tmp_path):
    cfg = _cfg(
        assets,
        range=dict(maximum_block_number=50, maximum_error_number=10**9),
        decoder=dict(true_h_arg=True),
        tpu=dict(batch=16),
    )
    sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    r = sim.run_snr_point(15.0)
    # chunk-granular: 16-block launches until the cap is covered, counting
    # the in-flight launch toward it (50 -> 4 launches = 64; the old
    # behavior over-launched a 5th)
    assert r.tot_blk == 64
    assert sim.batch == 16


def test_stopping_rule_max_errors(assets):
    cfg = _cfg(
        assets,
        range=dict(maximum_block_number=10**6, maximum_error_number=5),
        decoder=dict(true_h_arg=True),
        # chunks_per_launch=1 keeps this a tight unit test of the rule; the
        # error-cap overrun is one launch (chunks_per_launch * batch blocks)
        tpu=dict(batch=32, chunks_per_launch=1),
    )
    sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    # -5 dB: every block fails => first chunk already exceeds 5 errors
    r = sim.run_snr_point(-5.0)
    assert r.tot_blk == 64  # stop chunk + one in-flight chunk
    assert r.err_blk >= 5
    assert r.fer == r.err_blk / r.tot_blk


def test_checkpoint_resume(assets, tmp_path):
    ck = str(tmp_path / "ck.json")
    cfg = _cfg(
        assets,
        range=dict(maximum_block_number=20, maximum_error_number=10**9,
                   minimum_snr=10.0, maximum_snr=15.0, step_snr=5.0),
        decoder=dict(true_h_arg=True),
        tpu=dict(batch=16, checkpoint_path=ck),
    )
    sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    results1 = sim.simulate()
    assert len(results1) == 2
    state = json.load(open(ck))
    assert state["snr"]["10.000"]["done"] and state["snr"]["15.000"]["done"]
    # resume: everything restored, no new compute
    sim2 = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    results2 = sim2.simulate()
    assert [r.tot_blk for r in results2] == [r.tot_blk for r in results1]
    assert all(r.wall_s == 0.0 for r in results2)


def test_checkpoint_mid_point_resume(assets, tmp_path):
    """Kill mid SNR point -> resume loses at most one launch and lands on
    counters bit-identical to an uninterrupted sweep (VERDICT r2 item 4)."""
    from kmldpc_tpu.sim.chain import make_chunk_runner as _mcr

    def make_cfg(ck):
        return _cfg(
            assets,
            range=dict(maximum_block_number=100, maximum_error_number=10**9,
                       minimum_snr=2.0, maximum_snr=2.0),
            decoder=dict(true_h_arg=True),
            # data_parallel=1: the killing factory below is unsharded; the
            # resumed/control runs must use the same (unsharded) runner or
            # per-device key splitting changes the noise realizations
            tpu=dict(batch=8, chunks_per_launch=1, checkpoint_path=ck,
                     data_parallel=1),
        )

    class Boom(RuntimeError):
        pass

    def killing_factory(spec, batch, kill_at=5, calls={"n": 0}):
        real = _mcr(spec, batch, 1)

        def run(key, var):
            if calls["n"] == kill_at:
                raise Boom()
            calls["n"] += 1
            return real(key, var)

        run.blocks_per_launch = batch
        return run

    ck = str(tmp_path / "ck.json")
    sim = Simulator(make_cfg(ck), SimLogger(log_dir=None, stdout=False),
                    runner_factory=killing_factory)
    with pytest.raises(Boom):
        sim.simulate()
    part = json.load(open(ck))["snr"]["2.000"]
    assert not part.get("done")
    # 5 launches issued, double-buffered consumption lags one: >= 4 consumed
    assert part["chunks"] >= 4
    assert part["tot_blk"] == part["chunks"] * 8

    # resume with the normal runner
    sim2 = Simulator(make_cfg(ck), SimLogger(log_dir=None, stdout=False))
    resumed = sim2.simulate()

    # uninterrupted control run (separate checkpoint file)
    sim3 = Simulator(make_cfg(str(tmp_path / "ck2.json")),
                     SimLogger(log_dir=None, stdout=False))
    control = sim3.simulate()
    r, c = resumed[0], control[0]
    assert (r.tot_blk, r.err_blk, r.err_bit, r.tot_bit) == (
        c.tot_blk, c.err_blk, c.err_bit, c.tot_bit
    ), "resumed sweep must be bit-identical to an uninterrupted one"


def test_checkpoint_rejects_topology_change(assets, tmp_path):
    """The fingerprint includes the runner topology: a checkpoint written
    by the sequential path must NOT be silently merged into a folded (or
    differently-sharded) resume — the runners decompose launch keys
    differently, so mixing the streams would break bit-identical resume.
    Mismatch means a clean fresh start."""
    ck = str(tmp_path / "ck_topo.json")

    def cfg(**tpu_over):
        return _cfg(
            assets,
            range=dict(maximum_block_number=16, maximum_error_number=10**9,
                       minimum_snr=4.0, maximum_snr=6.0, step_snr=2.0),
            decoder=dict(true_h_arg=True),
            tpu=dict(batch=8, chunks_per_launch=1, checkpoint_path=ck,
                     data_parallel=1, **tpu_over),
        )

    Simulator(cfg(), SimLogger(log_dir=None, stdout=False)).simulate()
    fp_seq = json.load(open(ck))["fingerprint"]
    # resume under snr_fold: fingerprint differs -> fresh start, and the
    # folded run's own results are the folded ground truth
    sim2 = Simulator(cfg(snr_fold=2), SimLogger(log_dir=None, stdout=False))
    assert sim2._fingerprint() != fp_seq
    r2 = sim2.simulate()
    control = Simulator(
        _cfg(assets,
             range=dict(maximum_block_number=16, maximum_error_number=10**9,
                        minimum_snr=4.0, maximum_snr=6.0, step_snr=2.0),
             decoder=dict(true_h_arg=True),
             tpu=dict(batch=8, chunks_per_launch=1, data_parallel=1,
                      snr_fold=2)),
        SimLogger(log_dir=None, stdout=False),
    ).simulate()
    for a, b in zip(r2, control):
        assert (a.tot_blk, a.err_blk, a.err_bit) == (b.tot_blk, b.err_blk, b.err_bit)
    assert json.load(open(ck))["fingerprint"] == sim2._fingerprint()


def test_snr_fold_checkpoint_mid_sweep_resume(assets, tmp_path):
    """Kill a FOLDED sweep mid-flight -> the resumed sweep lands on
    counters bit-identical to an uninterrupted folded run (the per-point
    launch cursor in the checkpoint drives the same key sequence)."""

    def make_cfg(ck):
        return _cfg(
            assets,
            range=dict(maximum_block_number=32, maximum_error_number=10**9,
                       minimum_snr=2.0, maximum_snr=6.0, step_snr=2.0),
            decoder=dict(true_h_arg=True),
            tpu=dict(batch=8, chunks_per_launch=1, checkpoint_path=ck,
                     data_parallel=1, snr_fold=3),
        )

    class Boom(RuntimeError):
        pass

    ck = str(tmp_path / "ckf.json")
    sim = Simulator(make_cfg(ck), SimLogger(log_dir=None, stdout=False))
    real, calls = sim.runner, {"n": 0}

    def killing(keys, vars_):
        if calls["n"] == 2:  # third dispatch dies
            raise Boom()
        calls["n"] += 1
        return real(keys, vars_)

    killing.blocks_per_launch = real.blocks_per_launch
    sim.runner = killing
    with pytest.raises(Boom):
        sim.simulate()
    state = json.load(open(ck))
    assert any(not v.get("done") for v in state["snr"].values())

    resumed = Simulator(make_cfg(ck),
                        SimLogger(log_dir=None, stdout=False)).simulate()
    control = Simulator(make_cfg(str(tmp_path / "ckf2.json")),
                        SimLogger(log_dir=None, stdout=False)).simulate()
    for r, c in zip(resumed, control):
        assert (r.snr, r.tot_blk, r.err_blk, r.err_bit, r.tot_bit) == (
            c.snr, c.tot_blk, c.err_blk, c.err_bit, c.tot_bit
        ), "folded resume must be bit-identical to an uninterrupted sweep"


def test_thread_block_number_default_batch(assets):
    """[tpu].batch = 0 (default) falls back to [range].thread_block_number
    (the reference's per-task chunk size, simulator.cc:90-100)."""
    cfg = _cfg(
        assets,
        range=dict(maximum_block_number=10**6, thread_block_number=48),
        tpu=dict(batch=0),
    )
    sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    assert sim.batch == 48
    # smoke-test value 1 (the shipped config) -> 1024 default, capped by max_blk
    cfg2 = _cfg(
        assets,
        range=dict(maximum_block_number=10**6, thread_block_number=1),
        tpu=dict(batch=0),
    )
    sim2 = Simulator(cfg2, SimLogger(log_dir=None, stdout=False))
    assert sim2.batch == 1024


def test_histogram_mode(assets, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(
        assets,
        range=dict(maximum_block_number=8, maximum_error_number=10**9),
        decoder=dict(true_h_arg=False),
        histogram=dict(enable=True),
        tpu=dict(batch=8),
    )
    sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    sim.simulate()
    files = [f for f in os.listdir(".") if f.startswith("histogram_")]
    assert len(files) == 1
    rows = [line.split() for line in open(files[0]) if line.strip()]
    # exactly the requested blocks: the driver counts the in-flight launch
    # toward the block cap, so fixed-block sweeps no longer overrun
    assert len(rows) == 8
    for row in rows:
        vals = [float(v) for v in row]
        assert len(vals) == 4
        assert vals[0] == min(vals)  # rotated: min first (simulator.cc:158-162)


def test_cli_smoke(assets, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    rows_json = tmp_path / "rows.json"
    out = subprocess.run(
        [sys.executable, "-m", "kmldpc_tpu", str(assets / "config.toml"),
         "--no-log-file", "--seed", "1", "--json", str(rows_json)],
        capture_output=True, text=True, env=env, cwd=assets.parent, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BER Result" in out.stdout
    assert "FER Result" in out.stdout
    assert "Total time cost:" in out.stdout
    # --json writes the per-SNR rows tools/parity.py reads
    import json

    rows = json.loads(rows_json.read_text())
    assert rows and {"snr", "tot_blk", "err_blk", "err_bit", "tot_bit",
                     "err_bit_sq"} <= set(rows[0])


def test_chain_4psk_and_inactive_encoder(assets):
    """2bits_4PSK constellation + ldpc.active=false (all-zero codeword)."""
    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    const = parse_constellation(str(assets / "2bits_4PSK.txt"))
    spec = ChainSpec(
        code=code, constellation=const, known_h=True, fading=True,
        metric_type=False, metric_iter=5, max_iter=20,
        encoder_active=False, histogram=False,
    )
    run = make_chunk_runner(spec, batch=8)
    res = run(jax.random.key(0), np.float32(10 ** (-1.5)))
    # all-zero codeword at 15 dB known-h: decoder recovers the zero word
    assert int(res.err_blk) == 0


def test_truncated_hmatrix_named_error(tmp_path):
    from kmldpc_tpu.io import parse_hmatrix

    p = tmp_path / "bad.txt"
    p.write_text("hdr\n4 8 4\nhdr2\n0 2 0 1\n1 2 2\n")
    with pytest.raises(ValueError, match="truncated at row"):
        parse_hmatrix(str(p))


def test_random_symbols_distribution():
    from kmldpc_tpu.ops.source import random_symbols

    s = np.asarray(random_symbols(jax.random.key(0), 5, (4000,)))
    assert s.min() >= 0 and s.max() <= 4
    counts = np.bincount(s, minlength=5)
    assert (np.abs(counts / 4000 - 0.2) < 0.04).all()


def test_histogram_known_h_single_candidate(assets, tmp_path, monkeypatch):
    """Reference histogram mode with true_h_arg writes 1-element rows
    (GetHistogramData over the single candidate {true_h})."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(
        assets,
        range=dict(maximum_block_number=8, maximum_error_number=10**9),
        decoder=dict(true_h_arg=True),
        histogram=dict(enable=True),
        tpu=dict(batch=8),
    )
    sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    sim.simulate()
    files = [f for f in os.listdir(".") if f.startswith("histogram_")]
    assert len(files) == 1
    rows = [line.split() for line in open(files[0]) if line.strip()]
    assert rows and all(len(r) == 1 for r in rows)


def test_kmeans_dump_end_to_end(assets, tmp_path):
    """[tpu].kmeans_dump_dir writes per-block DumpToMat-parity files
    (kmeans.cc:96-111): data/cluster/idx/constellations/hHats/realH, with
    clusters = constellation * hhat and idx consistent with nearest-cluster
    assignment (VERDICT r2 missing #1)."""
    d = str(tmp_path / "km")
    cfg = _cfg(
        assets,
        range=dict(maximum_block_number=8, maximum_error_number=10**9),
        decoder=dict(true_h_arg=False),
        modem=dict(modem_file="4bit_16QAM_Gray.txt"),
        tpu=dict(batch=8, kmeans_dump_dir=d, kmeans_dump_blocks=4,
                 data_parallel=1),
    )
    sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    sim.run_snr_point(18.0)
    files = sorted(os.listdir(d))
    assert len(files) == 4, files
    data = np.load(os.path.join(d, files[0])) if files[0].endswith(".npz") else None
    if data is None:
        from scipy.io import loadmat

        data = loadmat(os.path.join(d, files[0]))
    y = np.asarray(data["data"]).ravel()
    cl = np.asarray(data["cluster"]).ravel()
    idx = np.asarray(data["idx"]).ravel().astype(int)
    const = np.asarray(data["constellations"]).ravel()
    h_hats = np.asarray(data["hHats"]).ravel()
    assert y.shape[0] == sim.code.num_col // 4  # Nsym for 16QAM
    assert cl.shape[0] == 16 and const.shape[0] == 16 and h_hats.shape[0] == 4
    # clusters are the constellation scaled by candidate 0's hhat
    np.testing.assert_allclose(cl, const * h_hats[0], rtol=1e-5, atol=1e-6)
    # idx is the nearest-cluster assignment of each received symbol
    d2 = np.abs(y[:, None] - cl[None, :]) ** 2
    np.testing.assert_array_equal(idx, d2.argmin(axis=1))


def test_awgn_h1_mode(assets):
    """[tpu].fading=false pins h=1 (driver config #0: AWGN)."""
    cfg = _cfg(
        assets,
        range=dict(maximum_block_number=16, maximum_error_number=10**9,
                   minimum_snr=3.0, maximum_snr=3.0),
        decoder=dict(true_h_arg=True),
        modem=dict(modem_file="2bits_QPSK.txt"),
        tpu=dict(batch=16, fading=False),
    )
    sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    r = sim.run_snr_point(3.0)
    # 3 dB AWGN h=1 is above the rate-1/2 QPSK threshold: zero errors,
    # while Rayleigh fading at the same SNR has FER ~0.5
    assert r.err_blk == 0


def test_parity_sweep_configs_load_and_trace():
    """Every committed parity-sweep config (benchmarks/parity/configs/)
    loads through the reference TOML schema, resolves its bundled assets,
    and traces a valid chunk program (jax.eval_shape — no compute).  Keeps
    the PARITY.md reproduction path from rotting."""
    import glob

    from kmldpc_tpu.sim.chain import build_chain_fn, make_chain_params

    root = pathlib.Path(__file__).resolve().parent.parent
    cfgs = sorted(glob.glob(str(root / "benchmarks" / "parity" / "configs" / "*.toml")))
    assert len(cfgs) >= 8, cfgs
    for path in cfgs:
        cfg = load_config(path)
        assert os.path.exists(cfg.matrix_path()), path
        assert os.path.exists(cfg.modem_path()), path
        code = load_code(cfg.matrix_path())
        const = parse_constellation(cfg.modem_path())
        spec = ChainSpec.from_config(cfg, code, const)
        # min-sum sweeps must engage the QC fast path on the 5G code
        if spec.schedule == "layered-minsum":
            from kmldpc_tpu.decoder.minsum import minsum_tables

            assert minsum_tables(code).qc is not None, path
        params = make_chain_params(spec)
        fn = build_chain_fn(spec, batch=4)
        out = jax.eval_shape(fn, params, jax.random.key(0), np.float32(0.1))
        assert out.tot_blk.shape == ()


def test_chain_rotated_16qam_labelings(assets):
    """The phi1/phi2 16QAM tables (inner-point-first row order) decode
    BLIND at high SNR.  This pins the anchor-scale fix in detect/kmeans.py:
    the reference divides its k-means anchor by constellations_[0]
    unconditionally (kmeans.cc:25,73), which breaks blind mode for any
    table whose row 0 is not a max-modulus point — with the old /s_0 the
    estimate converged 3x too large and ALL 8 blocks failed here."""
    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    for fname in ("4bit_16QAM_phi1.txt", "4bit_16QAM_phi2.txt"):
        const = parse_constellation(str(assets / fname))
        spec = ChainSpec(
            code=code, constellation=const, known_h=False, fading=True,
            metric_type=False, metric_iter=5, max_iter=30,
            encoder_active=True, histogram=False,
        )
        run = make_chunk_runner(spec, batch=8)
        res = run(jax.random.key(6), np.float32(10 ** (-2.4)))  # 24 dB
        assert int(res.tot_blk) == 8
        assert int(res.err_blk) == 0, (fname, int(res.err_blk))


def test_kmeans_impl_config_knob(assets):
    """[tpu].kmeans_impl reaches ChainSpec (and an unknown value fails at
    build time)."""
    cfg = _cfg(assets, tpu=dict(kmeans_impl="jax"))
    code = load_code(cfg.matrix_path())
    const = parse_constellation(cfg.modem_path())
    spec = ChainSpec.from_config(cfg, code, const)
    assert spec.kmeans_impl == "jax"
    bad = dataclasses.replace(spec, kmeans_impl="nope", known_h=False)
    import pytest as _pytest

    with _pytest.raises(Exception):
        make_chunk_runner(bad, batch=4)
