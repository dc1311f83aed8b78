"""Smoke run of the simulator on the GPU: its main path once, at real sizes.

    python chip_smoke.py                 # one GPU: phases 1-6
    python chip_smoke.py --four          # four GPUs: phase 1 and phase 7 only
    python chip_smoke.py --out DIR       # where phase 6 writes (default smoke_out/)

Phases (each prints its own lines; the first failure raises, so the
script exits non-zero and never prints the last line):

1. device: a GPU is required (no fallback); prints its kind, the device
   count and ``nvidia-smi``'s name and power limit of the card.
2. compile: the flagship chunk runner (PEG2304 + QPSK blind, batch 1024,
   16 chunks per launch) and the PEG8064 + 64QAM blind runner, each with
   the k-means kernel and with the plain estimator; compile seconds and
   ``memory_analysis()``.
3. k-means: the kernel against the plain estimator at real widths (B =
   1024, y = h·s + w at 15 dB), per-call times of both in turns, and both
   chains of phase 2 end to end in blocks/s, in turns.
4. demapper against the float64 NumPy oracle at B = 1024.
5. one flagship chunk on the CPU and on the GPU from the same key.
6. four parity sweeps through the CLI (``kmldpc_tpu.__main__.main``),
   each judged against its C++ reference log at |z| < 4.
7. (``--four``) the data-parallel Simulator sweep against a one-device
   replay of its per-shard keys, and the model-parallel chain on a 2 x 2
   mesh against the unsharded chain: counters must be equal.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import tomllib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from kmldpc_tpu.__main__ import main as cli_main  # noqa: E402
from kmldpc_tpu.code import load_code  # noqa: E402
from kmldpc_tpu.config import config_from_dict, load_config  # noqa: E402
from kmldpc_tpu.detect.kmeans import make_blind_estimator  # noqa: E402
from kmldpc_tpu.detect.kmeans_pallas import make_blind_estimator_pallas  # noqa: E402
from kmldpc_tpu.io import parse_constellation  # noqa: E402
from kmldpc_tpu.ops.channel import fading_awgn_channel  # noqa: E402
from kmldpc_tpu.ops.modem import ModemTables, make_soft_demapper  # noqa: E402
from kmldpc_tpu.parallel.edge_sharded import (  # noqa: E402
    get_mesh_2d,
    make_model_parallel_chunk_runner,
)
from kmldpc_tpu.sim import Simulator  # noqa: E402
from kmldpc_tpu.sim.chain import (  # noqa: E402
    ChainSpec,
    _fold_launch,
    build_chain_fn,
    build_frontend_fn,
    make_chain_params,
    make_chunk_runner,
)
from kmldpc_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from kmldpc_tpu.utils.logging import SimLogger  # noqa: E402
from tests.oracle import demap_llr_batch  # noqa: E402
from tools.parity import compare, parse_reference_log  # noqa: E402
from tools.device import card, describe, require_gpu  # noqa: E402
from tools.rows import CHAIN_ROWS, make_spec  # noqa: E402

ASSETS = os.path.join(HERE, "assets")
PARITY_DIR = os.path.join(HERE, "benchmarks", "parity")
VAR = np.float32(10.0 ** (-0.1 * 15.0))  # 15 dB

# The chains of phases 2-3: (bench row, batch, chunks per launch).
CHAINS = [("PEG2304+QPSK/blind", 1024, 16), ("PEG8064+64QAM/blind", 1024, 1)]
# Phase 3's k-means shapes: (label, constellation, symbols per block).
KMEANS_SHAPES = [
    ("PEG2304+QPSK", "2bits_QPSK.txt", 1152),
    ("PEG2304+16QAM", "4bit_16QAM_Gray.txt", 576),
    ("PEG2304+64QAM", "6bits_64QAM_Gray.txt", 384),
    ("PEG8064+64QAM", "6bits_64QAM_Gray.txt", 1344),
]
# ĥ agreement, judged per block.  The kernel and the plain estimator sum
# the same f32 values in another order, so ĥ differs by rounding (~1e-6
# relative at most); a block beyond 1e-4 relative is one where that
# rounding flipped an argmin near-tie and the iteration took another path.
# Such flips are rare (a symbol has to sit within rounding of a cluster
# boundary), so at most 1% of blocks may show one.
H_RTOL = 1e-4
H_MAX_SHARE = 0.01
# Demapper LLRs against the float64 oracle: f32 rounding gives ~1e-5 at
# these sizes; TF32 marginals (~1e-3 relative) would exceed this bound.
LLR_ATOL = 2e-4
# Phase 6: (config, reference log, record written, info bits per block).
SWEEPS = [
    ("sweep0_blind_qpsk", "ref_blind_qpsk.log", "ours_blind_qpsk_h100.json"),
    ("sweep2_blind_16qam", "ref_blind_16qam.log", "ours_blind_16qam_h100.json"),
    ("sweep3b_known_5g16qam_minsum", "ref_known_5g16qam.log",
     "ours_known_5g16qam_minsum_h100.json"),
    ("sweep5_blind_8064_64qam", "ref_blind_8064_64qam_r5.log",
     "ours_blind_8064_64qam_h100.json"),
]
Z_GATE = 4.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def row_spec(name: str, **over) -> ChainSpec:
    row = next(r for r in CHAIN_ROWS if r.name == name)
    return dataclasses.replace(make_spec(row, ASSETS), **over)


def modem_tables(fname: str):
    const = parse_constellation(os.path.join(ASSETS, fname))
    return const, ModemTables.from_constellation(const)


def channel_like(tables: ModemTables, b: int, nsym: int, key):
    """Random constellation symbols through the fading channel at 15 dB."""
    k_sym, k_chan = jax.random.split(key)
    idx = jax.random.randint(k_sym, (b, nsym), 0, tables.num_points)
    return fading_awgn_channel(
        k_chan, tables.points_re[idx], tables.points_im[idx], jnp.sqrt(VAR)
    )


def median(xs):
    return float(np.median(np.asarray(xs)))


def h_agreement(h_a, h_ref):
    """(max |Δĥ|, share of blocks beyond H_RTOL relative) for complex ĥ."""
    d = np.abs(h_a - h_ref)
    bad = d > H_RTOL * np.maximum(1.0, np.abs(h_ref))
    return float(d.max()), float(bad.mean())


# --- phase 1 ----------------------------------------------------------------
def phase_device(need: int):
    dev = require_gpu(need)
    print(f"[1 device] {describe(dev)}", flush=True)
    return dev


# --- phase 2 ----------------------------------------------------------------
def phase_compile() -> dict:
    key = jax.random.key(0)
    out = {}
    for name, batch, cpl in CHAINS:
        for impl in ("pallas", "jax"):
            runner = make_chunk_runner(row_spec(name, kmeans_impl=impl), batch, cpl)
            t0 = time.perf_counter()
            compiled = runner.lower(key, VAR).compile()
            dt = time.perf_counter() - t0
            ma = compiled.memory_analysis()
            print(f"[2 compile] {name} kmeans={impl} batch={batch} "
                  f"chunks/launch={cpl}: {dt:.1f} s; memory MiB: "
                  f"arguments {ma.argument_size_in_bytes / 2**20:.1f}, "
                  f"temp {ma.temp_size_in_bytes / 2**20:.1f}, "
                  f"output {ma.output_size_in_bytes / 2**20:.1f}", flush=True)
            out[name, impl] = (compiled, runner.params, batch * cpl)
    return out


# --- phase 3 ----------------------------------------------------------------
def _us_per_call(fn, args, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n * 1e6


def kmeans_agreement(label: str, fname: str, nsym: int, b: int, seed: int):
    """Check the kernel (and its early exit) against the plain estimator on
    channel-like input; returns the jitted implementations and the input."""
    _, tables = modem_tables(fname)
    yr, yi, _, _ = channel_like(tables, b, nsym, jax.random.key(seed))
    impls = {
        "xla": jax.jit(make_blind_estimator(tables, 20, "max")),
        "kernel": jax.jit(make_blind_estimator_pallas(tables, 20, "max")),
        "kernel_no_exit": jax.jit(
            make_blind_estimator_pallas(tables, 20, "max", early_exit=False)
        ),
    }
    outs = {k: jax.block_until_ready(f(yr, yi)) for k, f in impls.items()}
    h = {k: np.asarray(o[0][:, 0]) + 1j * np.asarray(o[1][:, 0])
         for k, o in outs.items()}
    dmax, share = h_agreement(h["kernel"], h["xla"])
    same = bool(np.array_equal(h["kernel"], h["kernel_no_exit"]))
    print(f"[3 kmeans] {label} B={b} Nsym={nsym}: max |dh| = {dmax:.3e}, "
          f"blocks beyond tolerance {share:.4f}; early exit bit-identical "
          f"to the full loop: {same}")
    check(share <= H_MAX_SHARE, f"{label}: kernel and reference disagree "
          f"on {share:.2%} of blocks")
    check(same, f"{label}: early exit changed the result")
    return impls, (yr, yi)


def phase_kmeans(compiled: dict, smi: str, b: int = 1024, turns: int = 5) -> None:
    print(f"[3 kmeans] card: {smi}; tolerance: |dh| <= {H_RTOL} * max(1, |h|) "
          f"in all but {H_MAX_SHARE:.0%} of blocks")
    for i, (label, fname, nsym) in enumerate(KMEANS_SHAPES):
        impls, args = kmeans_agreement(label, fname, nsym, b, 100 + i)
        us = {k: [] for k in impls}
        for _ in range(turns):
            for k, f in impls.items():
                us[k].append(_us_per_call(f, args, 20))
        med = {k: median(v) for k, v in us.items()}
        print(f"[3 kmeans] {label}: us/call median of {turns} turns: "
              + ", ".join(f"{k} {v:.1f}" for k, v in med.items()), flush=True)

    key = jax.random.key(7)
    for name, _, _ in CHAINS:
        rates = {"pallas": [], "jax": []}
        for t in range(turns):
            for impl in rates:
                fn, params, blocks = compiled[name, impl]
                n = 4
                t0 = time.perf_counter()
                for j in range(n):
                    r = fn(params, jax.random.fold_in(key, 1000 * t + j), VAR)
                jax.block_until_ready(r)
                rates[impl].append(n * blocks / (time.perf_counter() - t0))
        med = {k: median(v) for k, v in rates.items()}
        print(f"[3 kmeans] chain {name}: blocks/s median of {turns} turns: "
              f"kernel {med['pallas']:.1f}, xla {med['jax']:.1f} "
              f"(kernel/xla {med['pallas'] / med['jax']:.3f}); card: {smi}",
              flush=True)


# --- phase 4 ----------------------------------------------------------------
def phase_demap(b: int = 1024) -> None:
    for i, (fname, nsym) in enumerate(
        [("4bit_16QAM_Gray.txt", 576), ("6bits_64QAM_Gray.txt", 384)]
    ):
        const, tables = modem_tables(fname)
        yr, yi, hr, hi = channel_like(tables, b, nsym, jax.random.key(200 + i))
        _, llr = jax.jit(make_soft_demapper(tables))(yr, yi, hr, hi, VAR)
        y = np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)
        h = np.asarray(hr, np.float64) + 1j * np.asarray(hi, np.float64)
        ref = demap_llr_batch(y, h, float(VAR), const.points, const.bits)
        dev = float(np.abs(np.asarray(llr, np.float64) - ref).max())
        print(f"[4 demap] {fname} B={b} Nsym={nsym}: max |dLLR| vs float64 "
              f"oracle = {dev:.3e} (tolerance {LLR_ATOL})", flush=True)
        check(dev <= LLR_ATOL, f"{fname}: demapper LLRs off by {dev:.3e}")


# --- phase 5 ----------------------------------------------------------------
def _chunk_on(device, spec: ChainSpec, b: int, seed: int):
    """Front-end outputs and counters of one chunk on ``device``."""
    with jax.default_device(device):
        key = jax.random.key(seed)
        dspec = dataclasses.replace(spec, kmeans_dump=True)
        front = jax.jit(build_frontend_fn(dspec, b))
        uu, _, _, diag, _ = front(make_chain_params(dspec), key, VAR)
        res = make_chunk_runner(spec, b, 1)(key, VAR)
        yr, yi, _, _, _, h4_r, h4_i, hr, hi = diag
        return dict(
            uu=np.asarray(uu), y=np.asarray(yr) + 1j * np.asarray(yi),
            h=np.asarray(hr) + 1j * np.asarray(hi),
            hhat=np.asarray(h4_r[:, 0]) + 1j * np.asarray(h4_i[:, 0]),
            err_blk=int(res.err_blk), err_bit=int(res.err_bit),
        )


def phase_same_seed(b: int = 1024, seed: int = 1234) -> None:
    spec = row_spec("PEG2304+QPSK/blind")
    cpu = _chunk_on(jax.devices("cpu")[0], spec, b, seed)
    gpu = _chunk_on(jax.devices()[0], spec, b, seed)
    same_bits = bool(np.array_equal(cpu["uu"], gpu["uu"]))
    dy = float(np.abs(cpu["y"] - gpu["y"]).max())
    dh = float(np.abs(cpu["h"] - gpu["h"]).max())
    dmax, share = h_agreement(gpu["hhat"], cpu["hhat"])
    print(f"[5 same seed] flagship chunk B={b}: source bits equal: {same_bits}; "
          f"channel max |dy| = {dy:.3e}, max |dh_true| = {dh:.3e}; "
          f"hhat max |d| = {dmax:.3e}, blocks beyond tolerance {share:.4f}; "
          f"err_blk cpu {cpu['err_blk']} gpu {gpu['err_blk']}, "
          f"err_bit cpu {cpu['err_bit']} gpu {gpu['err_bit']}", flush=True)
    check(same_bits, "source bits differ between CPU and GPU")
    # the same threefry draws through the same f32 formula: at most a few
    # ulps apart (|y| stays below ~10)
    check(dy <= 1e-5 and dh <= 1e-5, "channel draws differ between CPU and GPU")
    check(share <= H_MAX_SHARE, f"hhat differs on {share:.2%} of blocks")
    check(cpu["err_blk"] == gpu["err_blk"], "err_blk differs between CPU and GPU")


# --- phase 6 ----------------------------------------------------------------
def phase_cli(out_dir: str) -> None:
    for cfg_name, ref_log, record in SWEEPS:
        cfg = os.path.join(PARITY_DIR, "configs", cfg_name + ".toml")
        cli_json = os.path.join(out_dir, cfg_name + ".cli.json")
        # the CLI's progress lines go to a file, not to this script's stdout
        t0 = time.perf_counter()
        with open(os.path.join(out_dir, cfg_name + ".log"), "w") as log, \
                contextlib.redirect_stdout(log):
            rc = cli_main([cfg, "--no-log-file", "--json", cli_json])
        wall = time.perf_counter() - t0
        check(rc == 0, f"{cfg_name}: CLI returned {rc}")
        with open(cli_json) as f:
            rows = json.load(f)
        # the committed record carries no rate: this run is not a benchmark
        rows = [{k: v for k, v in r.items() if k != "blocks_per_s"} for r in rows]
        with open(os.path.join(out_dir, record), "w") as f:
            json.dump(rows, f, indent=1)
            f.write("\n")
        info_bits = rows[0]["tot_bit"] // rows[0]["tot_blk"]
        cmp = compare(parse_reference_log(os.path.join(PARITY_DIR, ref_log)),
                      rows, info_bits)
        check(len(cmp) == len(rows), f"{cfg_name}: SNR grid differs from {ref_log}")
        worst = max(max(abs(r["z_fer"]), abs(r["z_ber"])) for r in cmp)
        pts = " ".join(f"{r['snr']:g}:{r['z_fer']:+.2f}/{r['z_ber']:+.2f}" for r in cmp)
        print(f"[6 cli] {cfg_name} vs {ref_log}: {sum(r['tot_blk'] for r in rows)} "
              f"blocks in {wall:.1f} s; z (FER/BER) per SNR {pts}; "
              f"worst |z| = {worst:.2f} (gate {Z_GATE})", flush=True)
        check(worst < Z_GATE, f"{cfg_name}: worst |z| = {worst:.2f}")


# --- phase 7 ----------------------------------------------------------------
def _sum_counters(results) -> tuple:
    """(err_blk, err_bit, tot_blk) summed over chunk results."""
    return tuple(sum(int(getattr(r, f)) for r in results)
                 for f in ("err_blk", "err_bit", "tot_blk"))


def phase_data_parallel(ndev: int = 4, batch: int = 1024, blocks: int = 4096,
                        snrs=(10.0, 15.0)) -> None:
    """The default Simulator sweep, sharded over every device, against a
    one-device replay of each launch's per-shard keys."""
    with open(os.path.join(PARITY_DIR, "configs", "sweep0_blind_qpsk.toml"), "rb") as f:
        raw = tomllib.load(f)
    raw["range"].update(minimum_snr=snrs[0], maximum_snr=snrs[-1],
                        step_snr=snrs[-1] - snrs[0], maximum_block_number=blocks)
    raw["tpu"] = dict(batch=batch, chunks_per_launch=2)
    cfg = config_from_dict(raw, asset_dir=ASSETS)
    check(len(jax.devices()) == ndev, f"expected {ndev} devices")
    sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    check(sim.batch == batch, "the Simulator changed the batch")
    results = sim.simulate()

    local = batch // ndev
    cpl = sim.runner.blocks_per_launch // batch
    one = jax.jit(_fold_launch(build_chain_fn(sim.spec, local), local, cpl))
    params = make_chain_params(sim.spec)
    for r in results:
        key = jax.random.fold_in(sim.root_key, int(round(r.snr * 1000)) & 0xFFFFFFFF)
        shards = []
        for launch in range(r.tot_blk // sim.runner.blocks_per_launch):
            for k in jax.random.split(jax.random.fold_in(key, launch), ndev):
                shards.append(one(params, k, np.float32(10.0 ** (-0.1 * r.snr))))
        replay = _sum_counters(shards)
        mesh = (r.err_blk, r.err_bit, r.tot_blk)
        print(f"[7 data parallel] SNR {r.snr:g}: {ndev}-device sweep "
              f"(err_blk, err_bit, tot_blk) = {mesh}, one-device replay "
              f"{replay}", flush=True)
        check(mesh == replay, f"SNR {r.snr}: sharded counters differ")


def phase_model_parallel(batch: int = 512, launches: int = 2) -> None:
    """The model-parallel chain on a 2 x 2 mesh against the unsharded chain
    run on one device over the same per-data-shard keys."""
    cfg = load_config(os.path.join(HERE, "configs", "peg8064_blind_model_parallel.toml"))
    spec = ChainSpec.from_config(
        cfg, load_code(cfg.matrix_path()), parse_constellation(cfg.modem_path())
    )
    ndata, nmodel = 2, 2
    run = make_model_parallel_chunk_runner(spec, batch, get_mesh_2d(ndata, nmodel))
    local = batch // ndata
    one = jax.jit(build_chain_fn(spec, local))
    params = make_chain_params(spec)
    var = np.float32(10.0 ** (-0.1 * cfg.range.minimum_snr))
    for launch in range(launches):
        key = jax.random.key(100 + launch)
        res = run(key, var)
        sharded = (int(res.err_blk), int(res.err_bit), int(res.tot_blk))
        ref = _sum_counters([one(params, k, var) for k in jax.random.split(key, ndata)])
        print(f"[7 model parallel] PEG8064+64QAM blind soft metric, "
              f"{ndata} data x {nmodel} model, batch {batch}, launch {launch}: "
              f"(err_blk, err_bit, tot_blk) sharded {sharded}, unsharded "
              f"{ref}", flush=True)
        check(sharded == ref, "model-parallel counters differ")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths (phase 7)")
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out"),
                    help="directory for phase 6's per-sweep JSON records")
    args = ap.parse_args()
    enable_compile_cache()
    t0 = time.perf_counter()
    dev = phase_device(4 if args.four else 1)
    if args.four:
        phase_data_parallel()
        phase_model_parallel()
    else:
        os.makedirs(args.out, exist_ok=True)
        smi = card()
        compiled = phase_compile()
        phase_kmeans(compiled, smi)
        del compiled
        phase_demap()
        phase_same_seed()
        phase_cli(args.out)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s; "
          f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
