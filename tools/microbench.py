"""GPU microbenchmarks: decoder µs/iteration, k-means µs/call, chunk blk/s.

A per-component performance claim should be reproducible by a row of this
harness.  A GPU is required; the device and the card's name and power
limit are printed first and recorded under ``"device"``.

Usage:
    timeout 900 python tools/microbench.py [--json out.json] [group ...]

Groups (default: all):
    decoder   µs/iteration of each decode schedule per code, at an SNR low
              enough that no codeword converges (so cost = max_iter sweeps)
    kmeans    µs per 20-iteration blind estimate, plain (XLA) vs kernel
    chain     blk/s of full chunk pipelines (tools/rows.py CHAIN_ROWS)

Methodology matches bench.py: pipelined dispatch, adaptive warmup until
two consecutive probes agree, steady-state timing by a two-point slope.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

ASSETS = os.path.join(HERE, "assets")

# Incremental result sink: set from --json.  Every completed row is flushed
# to disk immediately, so a run cut by its time limit keeps what it
# measured.
_JSON_PATH: str | None = None


def _save(results: dict) -> None:
    if _JSON_PATH:
        tmp = _JSON_PATH + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f, indent=1)
            f.write("\n")
        os.replace(tmp, _JSON_PATH)


def steady(fn, n1: int = 6, n2: int | None = None, passes: int = 1):
    """Steady-state seconds per call via a two-point slope.

    ``fn(i)`` must dispatch device work for index ``i`` and return a 0-d jax
    array derived from ALL of it.  Each batch of calls is accumulated into
    one scalar and read back once — the readback is the fence — and the
    (n2 - n1)-call slope cancels the fixed per-run cost.  Inputs must be
    unique per call (fold a key by ``i``).

    ``passes > 1`` repeats the slope measurement that many times
    (interleaved, after the shared warmup) and quotes the MEDIAN.

    ``n2 = None`` (default) sizes the long run from the warmup estimate
    (tools/rows.py pick_n2).

    Returns ``(sec_per_call_median, spread_pct)``; spread is 0.0 for
    ``passes=1``.
    """
    import numpy as np

    from tools.rows import pick_n2

    def run(n: int, base: int) -> float:
        t0 = time.perf_counter()
        acc = fn(base)
        for i in range(1, n):
            acc = acc + fn(base + i)
        np.asarray(acc)  # single scalar readback = execution fence
        return time.perf_counter() - t0

    prev = None
    for probe in range(10):  # adaptive warmup: first executions cost more
        dt = run(3, 1_000 + 3 * probe)
        if prev is not None and probe >= 1 and dt < prev * 1.15 and prev < dt * 1.15:
            break
        prev = dt
    if n2 is None:
        n2 = max(18, pick_n2(prev / 3 if prev else 0.0, n1))
    vals = []
    fallback = None
    for p in range(2 * passes):  # retry budget for disturbed passes
        t1 = run(n1, 2_000 + 200 * p)
        t2 = run(n2, 3_000 + 200 * p)
        fallback = t2 / n2  # always-positive upper bound
        slope = (t2 - t1) / (n2 - n1)
        # a stall during the short run can make the slope <= 0 — discard
        if slope > 0:
            vals.append(slope)
            if len(vals) == passes:
                break
    if not vals:
        return fallback, 0.0
    vals.sort()
    med = vals[len(vals) // 2]
    spread = (vals[-1] - vals[0]) / med * 100.0 if len(vals) > 1 else 0.0
    return med, spread


def bench_decoders(results: dict, batch: int = 1024, iters: int = 20,
                   passes: int = 1) -> None:
    import jax
    import jax.numpy as jnp

    from kmldpc_tpu.code import load_code
    from kmldpc_tpu.decoder.bp import DecoderTables, flooding_decode
    from kmldpc_tpu.decoder.bp_em import flooding_decode_em
    from kmldpc_tpu.decoder.minsum import layered_minsum_decode, minsum_tables

    base_key = jax.random.key(7)
    # most important first: a run cut by its time limit keeps PEG8064
    for name, fname in [
        ("PEG8064", "PEG8064regular0.5.txt"),
        ("5G-BG2-K960", "5GLDPCBG2a3_R12_K960.txt"),
        ("PEG2304", "PEG2304regular0.5.txt"),
    ]:
        code = load_code(os.path.join(ASSETS, fname))
        dt = DecoderTables.from_code(code)
        mt = minsum_tables(code)
        tx_len = code.num_col - code.punct

        # Noise is generated ON DEVICE from a per-call index (unique inputs
        # per dispatch); LLR scale 0.3 is too weak to ever converge, so cost
        # = `iters` full sweeps.  The scalar satisfies steady()'s fence
        # contract; the full result keeps the decode from being trimmed to
        # the part the scalar needs.
        def llr_of(i):
            key = jax.random.fold_in(base_key, i)
            return 0.3 * jax.random.normal(key, (batch, tx_len), dtype="float32")

        flood = jax.jit(
            lambda t, i: (lambda r: (r.iters.sum(), r))(
                flooding_decode(t, llr_of(i), iters)
            )
        )
        flood_em = jax.jit(
            lambda t, i: (lambda r: (r.iters.sum(), r))(
                flooding_decode_em(t, llr_of(i), iters)
            )
        )
        ms = jax.jit(
            lambda t, i: (lambda r: (r.iters.sum(), r))(
                layered_minsum_decode(t, llr_of(i), iters, 0.75)
            )
        )
        fms = jax.jit(
            lambda t, i: (lambda r: (r.iters.sum(), r))(
                flooding_decode_em(t, llr_of(i), iters, cn_rule="minsum")
            )
        )
        rows = [
            ("flooding", flood, dt),
            # the production layout (slot-major / degree-class core used by
            # the chain's two-phase path)
            ("flooding[em]", flood_em, dt),
            # min-sum CN rule on the flooding schedule (no transcendentals)
            ("flooding-minsum[em]", fms, dt),
            (f"minsum[{'qc' if mt.qc else 'generic'}]", ms, mt),
        ]
        if mt.qc is not None:
            mt_gen = minsum_tables(code, layer_size=code.lifting_factor, use_qc=False)
            rows.append(("minsum[generic]", ms, mt_gen))

        for label, fn, tabs in rows:
            sec, spread = steady(lambda i: fn(tabs, jnp.int32(i))[0],
                                 passes=passes)
            us_per_iter = sec / iters * 1e6
            key = f"decoder/{name}/{label}"
            results[key] = {"us_per_iter": round(us_per_iter, 1),
                            "spread_pct": round(spread, 1),
                            "batch": batch, "iters": iters}
            _save(results)
            print(f"{key}: {us_per_iter:.0f} us/iter ±{spread:.1f}% "
                  f"({sec*1e3:.2f} ms / {iters} iters, B={batch})", file=sys.stderr)


def bench_kmeans(results: dict, batch: int = 1024, nsym: int = 1152,
                 passes: int = 1) -> None:
    import jax
    import jax.numpy as jnp

    from kmldpc_tpu.detect.kmeans import make_blind_estimator
    from kmldpc_tpu.io import parse_constellation
    from kmldpc_tpu.ops.modem import ModemTables

    from kmldpc_tpu.detect.kmeans_pallas import make_blind_estimator_pallas

    for cname, fname, n in [
        ("QPSK", "2bits_QPSK.txt", nsym),
        ("16QAM", "4bit_16QAM_Gray.txt", nsym // 2),
        ("64QAM", "6bits_64QAM_Gray.txt", nsym // 3),
    ]:
        tables = ModemTables.from_constellation(
            parse_constellation(os.path.join(ASSETS, fname))
        )
        base_key = jax.random.key(3)

        def y_of(i):  # unique on-device inputs per dispatch (see decoder note)
            y = jax.random.normal(
                jax.random.fold_in(base_key, i), (2, batch, n), dtype="float32"
            )
            return y[0], y[1]

        impls = {"jax": make_blind_estimator(tables, 20, "max"),
                 "pallas": make_blind_estimator_pallas(tables, 20, "max")}
        for impl, est in impls.items():
            # (scalar, full outputs) — see decoder note on the fence contract
            jest = jax.jit(
                lambda i, _est=est: (lambda hr, hi: (hr.sum() + hi.sum(), (hr, hi)))(
                    *_est(*y_of(i))
                )
            )
            sec, spread = steady(lambda i: jest(jnp.int32(i))[0], passes=passes)
            key = f"kmeans/{cname}/{impl}"
            results[key] = {"us_per_call": round(sec * 1e6, 1),
                            "spread_pct": round(spread, 1),
                            "batch": batch, "nsym": n}
            _save(results)
            print(f"{key}: {sec*1e6:.0f} us/call ±{spread:.1f}% "
                  f"(B={batch}, {n} sym)", file=sys.stderr)


# The chain row matrix lives in tools/rows.py — ONE definition shared with
# bench.py and pinned by tests/test_bench_rows.py.
from tools.rows import CHAIN_ROWS, make_spec  # noqa: E402

_PRIMARY = ("us_per_iter", "us_per_call", "blocks_per_s")


def bench_chain(results: dict, only: str | None = None,
                passes: int = 3) -> None:
    import jax
    import numpy as np

    from kmldpc_tpu.sim.chain import make_chunk_runner

    key = jax.random.key(0)
    for r in CHAIN_ROWS:
        if only and only not in r.name:
            continue
        batch = r.batch or 1024
        cpl = r.cpl or 16
        spec = make_spec(r, ASSETS)
        runner = make_chunk_runner(spec, batch, cpl)
        var = np.float32(10.0 ** (-0.1 * r.snr_db))
        # err_blk is a scalar ChunkResult field — satisfies the fence contract
        sec, spread = steady(
            lambda i: runner(jax.random.fold_in(key, i), var).err_blk,
            passes=passes,
        )
        blk_s = batch * cpl / sec
        results[f"chain/{r.name}"] = {
            "blocks_per_s": round(blk_s, 1),
            "info_bits_per_s": round(blk_s * spec.code.code_dim, 1),
            "spread_pct": round(spread, 1),
            "batch": batch, "chunks_per_launch": cpl, "snr_db": r.snr_db,
        }
        _save(results)
        print(f"chain/{r.name}: {blk_s:,.0f} blk/s ±{spread:.1f}% "
              f"({sec/cpl*1e3:.2f} ms/chunk, B={batch} cpl={cpl})",
              file=sys.stderr)


def diff_against(results: dict, baseline_path: str) -> list[dict]:
    """Print (and return) a per-row regression report vs a baseline JSON.

    Rows sharing a key are compared on their primary metric (us_per_iter /
    us_per_call: lower is better; blocks_per_s: higher is better).  Rows
    present on only one side are listed, so a dropped row cannot hide.
    Compare two files only from the same card at the same power limit
    (both record it under ``"device"``).
    """
    with open(baseline_path) as f:
        base = json.load(f)
    keys = sorted((set(base) | set(results)) - {"device"})
    print(f"--- diff vs {baseline_path} ---", file=sys.stderr)
    report: list[dict] = []
    for k in keys:
        b, r = base.get(k), results.get(k)
        if b is None or r is None:
            note = "NEW" if b is None else "MISSING (was in baseline)"
            print(f"{k}: {note}", file=sys.stderr)
            report.append({"row": k, "note": note})
            continue
        for m in _PRIMARY:
            if m in b and m in r and b[m]:
                better_low = m.startswith("us_")
                bv, rv = b[m], r[m]
                change = (rv - bv) / bv * 100.0
                word = ("slower" if change > 0 else "faster") if better_low else \
                       ("faster" if change > 0 else "slower")
                print(f"{k}: {m} {bv:,} -> {rv:,} ({abs(change):.1f}% {word})",
                      file=sys.stderr)
                report.append({"row": k, "metric": m, "base": bv, "new": rv,
                               "change_pct": change, "worse": (change > 0) == better_low})
                break
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("groups", nargs="*", default=[],
                    help="decoder kmeans chain (default all); or chain:<substr>")
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("--diff", default=None,
                    help="baseline JSON from an earlier run to report per-row "
                         "changes against")
    ap.add_argument("--passes", type=int, default=None,
                    help="interleaved slope passes per row (median + spread; "
                         "default: 3 for chain, 1 for decoder/kmeans)")
    args = ap.parse_args()
    groups = args.groups or ["decoder", "kmeans", "chain"]
    global _JSON_PATH
    _JSON_PATH = args.json

    from kmldpc_tpu.utils.compile_cache import enable_compile_cache
    from tools.device import describe, require_gpu

    enable_compile_cache()
    device = describe(require_gpu())
    print(f"microbench: {device}", file=sys.stderr)
    results: dict = {"device": device}
    for g in groups:
        if g == "decoder":
            bench_decoders(results, passes=args.passes or 1)
        elif g == "kmeans":
            bench_kmeans(results, passes=args.passes or 1)
        elif g == "chain":
            bench_chain(results, passes=args.passes or 3)
        elif g.startswith("chain:"):
            bench_chain(results, only=g.split(":", 1)[1],
                        passes=args.passes or 3)
        else:
            raise SystemExit(f"unknown group {g!r}")
    out = json.dumps(results, indent=1)
    _save(results)
    if args.diff:
        diff_against(results, args.diff)
    print(out)


if __name__ == "__main__":
    main()
