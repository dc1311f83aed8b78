"""Wall-clock A/B of [tpu].snr_fold on a short many-point sweep.

The reference runs every SNR point concurrently (one pool thread per
point, simulator.cc:27,35-42); the plain sweep here is sequential per
point, and ``snr_fold`` packs m whole launches — round-robined over the
live points — into one dispatch.  This measures the criterion behind the
feature: a short 7-point sweep (the parity-config shape: a few seconds per
point, where per-point pipeline fill/drain and dispatch round-trips are a
real fraction of the wall-clock) runs faster folded, with bit-identical
per-point counters.

One process on one GPU: both programs are compiled and warmed with a full
sweep each, then the SECOND run of each is timed, so compilation stays
out of the comparison.

Usage:  timeout 1800 python -u tools/snrfold_bench.py [--json f]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def build_cfg(snr_fold: int, blocks: int = 4096, batch: int = 1024):
    from kmldpc_tpu.config import config_from_dict

    return config_from_dict(
        {
            "range": {
                "minimum_snr": 0.0, "maximum_snr": 30.0, "step_snr": 5.0,
                "maximum_error_number": 10**9, "maximum_block_number": blocks,
                "thread_block_number": 1,
            },
            "decoder": {"true_h_arg": True},
            "xcodec": {"5gldpc": False, "metric_type": False, "metric_iter": 5},
            "histogram": {"enable": False},
            "ldpc": {"max_iter": 50, "active": True,
                     "matrix_file": "PEG2304regular0.5.txt"},
            "modem": {"modem_file": "2bits_QPSK.txt"},
            "tpu": {"batch": batch, "chunks_per_launch": 1,
                    "data_parallel": 1, "snr_fold": snr_fold, "seed": 3},
        },
        asset_dir=os.path.join(HERE, "assets"),
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--blocks", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args()

    from kmldpc_tpu.sim import Simulator
    from kmldpc_tpu.utils.compile_cache import enable_compile_cache
    from kmldpc_tpu.utils.logging import SimLogger
    from tools.device import describe, require_gpu

    enable_compile_cache()
    device = describe(require_gpu())
    print(f"snrfold_bench: {device}", file=sys.stderr)
    results: dict = {"device": device}
    counters: dict = {}
    for name, fold in (("sequential", 0), ("folded7", 7)):
        sim = Simulator(build_cfg(fold, args.blocks, args.batch),
                        SimLogger(log_dir=None, stdout=False))
        sim.simulate()  # compile + warmup (full sweep)
        t0 = time.perf_counter()
        rs = sim.simulate()
        dt = time.perf_counter() - t0
        counters[name] = [(r.snr, r.tot_blk, r.err_blk, r.err_bit) for r in rs]
        results[f"snrfold/{name}"] = {
            "wall_s": round(dt, 3),
            "points": len(rs),
            "blocks": sum(r.tot_blk for r in rs),
        }
        print(f"snrfold/{name}: {dt:.3f} s for {len(rs)} points "
              f"({sum(r.tot_blk for r in rs)} blocks)", file=sys.stderr)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=1)
    assert counters["sequential"] == counters["folded7"], (
        "per-point counters must be bit-identical",
        counters,
    )
    seq = results["snrfold/sequential"]["wall_s"]
    fold = results["snrfold/folded7"]["wall_s"]
    results["snrfold/speedup"] = round(seq / fold, 3)
    print(f"snrfold/speedup: {seq / fold:.3f}x (counters bit-identical)",
          file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
