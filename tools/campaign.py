"""Multi-config Monte-Carlo campaign runner (driver config #4).

Runs every TOML config given (files or directories) through the Simulator
sequentially — codes x modulations x SNR grids — writing one JSON result
per config plus a campaign summary.  Each config independently uses the
full device mesh (multi-host included via the standard jax.distributed
environment).

Usage: python tools/campaign.py out_dir cfg1.toml [cfg2.toml | dir ...]
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def expand(paths: list[str]) -> list[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                os.path.join(p, f) for f in sorted(os.listdir(p)) if f.endswith(".toml")
            )
        else:
            out.append(p)
    return out


def main() -> int:
    from kmldpc_tpu.config import load_config
    from kmldpc_tpu.sim import Simulator
    from kmldpc_tpu.utils.compile_cache import enable_compile_cache
    from kmldpc_tpu.utils.logging import SimLogger

    enable_compile_cache()

    out_dir = sys.argv[1]
    os.makedirs(out_dir, exist_ok=True)
    configs = expand(sys.argv[2:])
    summary = []
    for path in configs:
        name = os.path.splitext(os.path.basename(path))[0]
        print(f"=== {name} ===", flush=True)
        t0 = time.monotonic()
        cfg = load_config(path)
        sim = Simulator(cfg, SimLogger(log_dir=None))
        results = sim.simulate()
        wall = time.monotonic() - t0
        rows = [r.as_row() for r in results]
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(rows, f, indent=1)
        summary.append(dict(config=name, wall_s=round(wall, 2),
                            points=len(rows),
                            blocks=sum(r.tot_blk for r in results)))
    with open(os.path.join(out_dir, "campaign.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
