"""Benchmark: decoded info bits/s on one GPU across the headline configurations.

Prints ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": "info_bits/s", "vs_baseline": N}

The headline number is the *blind-detection* pipeline (k-means + 4-candidate
ambiguity metrics + flooding BP to 50 iters) on PEG2304 R=1/2 + QPSK at
15 dB — the reference's flagship mode — measured in steady state on one
GPU.  ``vs_baseline`` is the ratio to the single-core C++ reference
(BASELINE_MEASURED.json: 296.5 blocks/s blind, 749.5 blocks/s known-h at
the same operating point).

A GPU is required.  The device (platform, kind, count) and the card's name
and power limit go to stderr first.  Beyond the headline, every row of
``tools/rows.py``'s bench subset is measured by the same run and goes to
stderr as its own ``bench-row`` JSON line.  A wall-clock budget
(KMLDPC_BENCH_BUDGET_S, default 840 s) bounds the run: rows that would not
fit are reported as skipped on stderr — never silently.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

T0 = time.monotonic()
BUDGET_S = float(os.environ.get("KMLDPC_BENCH_BUDGET_S", "840"))


def left() -> float:
    return BUDGET_S - (time.monotonic() - T0)


# Adaptive long-run sizing (shared with tools/microbench.py).
from tools.rows import pick_n2  # noqa: E402


def measure(runner, key, var, passes: int = 3, n1: int = 4, n2: int | None = None):
    """Steady-state seconds per chunk: median of ``passes`` two-point
    slopes, plus the min-max spread across passes.

    Chunks are dispatched back-to-back without intermediate syncs — exactly
    how the Monte-Carlo driver issues them (double-buffered, see
    sim/montecarlo.py).  Each pass times a run of ``n1`` and a run of
    ``n2`` pipelined chunks and takes the slope ``(t2 - t1)/(n2 - n1)``:
    the fixed per-run cost (pipeline fill and drain plus the final
    block_until_ready) cancels, so the quoted number is steady-state
    throughput.

    Warmup runs small batches of chunks until two consecutive ones agree,
    so first-execution costs (autotuning, lazy loading) stay out of the
    measured runs.  The MEDIAN of ``passes`` interleaved slopes is quoted
    and ``spread_pct`` = (max - min)/median carries the in-run uncertainty
    into every reported row.

    ``n2 = None`` sizes the long run per row from the warmup estimate
    (:func:`pick_n2`) so fast rows measure a steady-state span that
    dominates the fixed per-run cost.

    Returns ``(sec_per_chunk_median, spread_pct)``.
    """
    import jax

    def run(n: int, base: int) -> float:
        t0 = time.perf_counter()
        res = [runner(jax.random.fold_in(key, base + i), var) for i in range(n)]
        jax.block_until_ready(res)
        return time.perf_counter() - t0

    prev = None
    for i in range(12):  # each probe = 3 pipelined chunks
        dt = run(3, 3 * i)
        if prev is not None and i >= 2 and dt < prev * 1.15 and prev < dt * 1.15:
            break
        prev = dt
    if n2 is None:
        n2 = pick_n2(prev / 3 if prev else 0.0, n1)
    secs = []
    fallback = None
    for p in range(2 * passes):  # retry budget for disturbed passes
        t1 = run(n1, 1_000 + 100 * p)
        t2 = run(n2, 5_000 + 100 * p)
        fallback = t2 / n2  # always-positive upper bound on sec/chunk
        slope = (t2 - t1) / (n2 - n1)
        # A stall during the SHORT run can make t1 > t2 and the slope
        # non-positive; a negative sec would leak into the one-line JSON as
        # negative throughput.  Discard and retry.
        if slope > 0:
            secs.append(slope)
            if len(secs) == passes:
                break
    if not secs:
        return fallback, 0.0
    secs.sort()
    med = secs[len(secs) // 2]
    spread = (secs[-1] - secs[0]) / med * 100.0
    return med, spread


def main() -> None:
    import jax
    import numpy as np

    from kmldpc_tpu.sim.chain import make_chunk_runner
    from kmldpc_tpu.utils.compile_cache import enable_compile_cache
    from tools.device import describe, require_gpu
    from tools.rows import bench_rows, make_spec

    enable_compile_cache()
    dev = require_gpu()
    batch_env = int(os.environ.get("KMLDPC_BENCH_BATCH", "1024"))
    # "float32" (reference-parity default) or "bfloat16" (opt-in message
    # storage dtype; statistically equivalent BER/FER — see PARITY.md).
    dtype = os.environ.get("KMLDPC_BENCH_DTYPE", "float32")
    # sub-chunks folded per device launch (see sim/chain.py
    # make_chunk_runner). The bench uses 16 — pure-throughput setting; the
    # Simulator defaults to 8 to keep stopping-rule granularity at 8k
    # blocks.
    cpl_env = int(os.environ.get("KMLDPC_BENCH_CPL", "16"))
    key = jax.random.key(0)

    print(f"bench: {describe(dev)}; batch={batch_env} budget={BUDGET_S:.0f}s",
          file=sys.stderr)

    headline_bits = None
    for i, r in enumerate(bench_rows()):
        batch = r.batch or batch_env
        cpl = r.cpl or cpl_env
        # The first two rows are mandatory (the headline + its known-h
        # A/B); later rows yield to the budget.  Never skip silently.
        if i >= 2 and left() < 150:
            print(f"bench: SKIPPED {r.name} (budget: {left():.0f}s left)",
                  file=sys.stderr)
            continue
        spec = make_spec(r, os.path.join(HERE, "assets"), dtype=dtype)
        runner = make_chunk_runner(spec, batch, cpl)
        var = np.float32(10.0 ** (-0.1 * r.snr_db))
        sec, spread = measure(runner, jax.random.fold_in(key, i), var)
        sec /= cpl
        blk_s = batch / sec
        bits_s = blk_s * spec.code.code_dim
        row = {
            "blocks_per_s": round(blk_s, 1),
            "info_bits_per_s": round(bits_s, 1),
            "spread_pct": round(spread, 1),
            "batch": batch, "chunks_per_launch": cpl, "snr_db": r.snr_db,
            "schedule": r.schedule,
        }
        print("bench-row " + json.dumps({"row": r.name, **row}), file=sys.stderr)
        if r.bench_rank == 0:
            headline_bits = bits_s

    # Single-core C++ reference at the same operating point
    # (BASELINE_MEASURED.json).
    with open(os.path.join(HERE, "BASELINE_MEASURED.json")) as f:
        baseline_blind_bits = json.load(f)["blind"]["info_bits_per_s"]

    print(
        json.dumps(
            {
                "metric": "blind decoded info bits/s/chip (PEG2304 R=1/2 QPSK, 15 dB, kmeans+metrics+50-iter BP)",
                "value": round(headline_bits, 1),
                "unit": "info_bits/s",
                "vs_baseline": round(headline_bits / baseline_blind_bits, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
