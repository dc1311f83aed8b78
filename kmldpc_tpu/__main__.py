"""CLI entry point: ``python -m kmldpc_tpu [config.toml]``.

Mirrors ``main()`` (kmldpc.cpp:10-56): logging bootstrap into
``logs/<timestamp>-kmldpc.logger`` + stdout, config parse, sweep, total
wall-clock printed as ``min:sec:ms``.  Unlike the reference (which only ever
reads ``./config.toml`` and has no flags), the config path is an optional
argument and a few overrides are exposed.
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import load_config
from .sim.montecarlo import Simulator
from .utils.logging import SimLogger


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="kmldpc_tpu", description="kmldpc link-level simulator (JAX)"
    )
    parser.add_argument("config", nargs="?", default="config.toml")
    parser.add_argument("--log-dir", default="logs")
    parser.add_argument("--no-log-file", action="store_true")
    parser.add_argument("--batch", type=int, default=None, help="override [tpu].batch")
    parser.add_argument("--seed", type=int, default=None, help="override [tpu].seed")
    parser.add_argument("--json", default=None,
                        help="also write the per-SNR results to this JSON file")
    args = parser.parse_args(argv)

    t0 = time.monotonic()
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from .parallel.distributed import is_primary, maybe_initialize

    multiproc = maybe_initialize()
    primary = is_primary()
    # secondary hosts run the same loop silently (counters are replicated,
    # so their stop decisions match process 0's)
    logger = SimLogger(
        log_dir=None if (args.no_log_file or not primary) else args.log_dir,
        stdout=primary,
    )
    if multiproc and primary:
        import jax

        logger.info(
            f"Distributed: {jax.process_count()} processes, "
            f"{len(jax.devices())} devices total"
        )
    logger.info("Start simulation")
    try:
        cfg = load_config(args.config)
    except OSError as e:
        logger.error(f"Encouter error while opening {args.config}: {e}")
        return 1
    if args.batch is not None or args.seed is not None:
        import dataclasses

        tpu = cfg.tpu
        if args.batch is not None:
            tpu = dataclasses.replace(tpu, batch=args.batch)
        if args.seed is not None:
            tpu = dataclasses.replace(tpu, seed=args.seed)
        cfg = dataclasses.replace(cfg, tpu=tpu)

    # the reference build creates records/ and logs/ next to the binary
    # (kmldpc/CMakeLists.txt:26-30); keep the same working-dir contract
    if primary and not args.no_log_file:
        import os

        os.makedirs("records", exist_ok=True)

    sim = Simulator(cfg, logger)
    results = sim.simulate()
    logger.info("Simulation done")
    if args.json and primary:
        import json

        with open(args.json, "w") as f:
            json.dump([r.as_row() for r in results], f, indent=1)

    total_ms = int((time.monotonic() - t0) * 1000)
    minutes, rem = divmod(total_ms, 60_000)
    seconds, ms = divmod(rem, 1000)
    logger.info(f"Total time cost: {minutes}min:{seconds}sec:{ms}ms")
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
