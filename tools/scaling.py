"""Scaling-efficiency measurement: samples/s vs mesh size.

Runs the blind Monte-Carlo chunk on 1..N devices (same global batch per
device) and reports throughput + efficiency relative to linear scaling.

On several GPUs this measures the scaling of the data-parallel runner
(BASELINE.md target: >=80%).  On a virtual-CPU mesh the numbers only
validate the mechanism (virtual devices share the same physical cores).

Usage:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/scaling.py [per_device_batch]
    ... python tools/scaling.py edge [batch]    # edge-sharded decoder mode

``edge`` mode scales the OTHER axis: the edge-sharded decoder
(parallel/edge_sharded.py) on the largest code (PEG8064), message state
split over 1..N row shards at a fixed batch — the model-parallel analogue
(SURVEY §2).  Decode-only timing.
"""

from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main_edge() -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from kmldpc_tpu.code import load_code
    from kmldpc_tpu.parallel.edge_sharded import make_edge_sharded_decoder

    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    code = load_code(os.path.join(HERE, "assets", "PEG8064regular0.5.txt"))
    ndev_all = len(jax.devices())
    rng = np.random.default_rng(0)
    # weak LLRs: nothing converges, cost = full 20 sweeps
    llr = jax.numpy.asarray(
        0.3 * rng.standard_normal((batch, code.num_col)), jax.numpy.float32
    )
    print(f"devices available: {ndev_all} ({jax.devices()[0].platform})")
    base = None
    for n in [m for m in (1, 2, 4, 8, 16, 32) if m <= ndev_all]:
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("model",))
        dec = make_edge_sharded_decoder(code, mesh)
        r = dec(llr, 20)
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        rs = [dec(llr, 20) for _ in range(3)]
        jax.block_until_ready(rs)
        dt = (time.perf_counter() - t0) / 3
        if base is None:
            base = dt
        print(
            f"row shards={n:3d}  {dt*1e3:8.1f} ms / 20-iter decode "
            f"(B={batch})  speedup {base/dt:5.2f}x"
        )


def main() -> None:
    import jax
    import numpy as np

    from kmldpc_tpu.code import load_code
    from kmldpc_tpu.io import parse_constellation
    from kmldpc_tpu.parallel.sharding import get_mesh, make_sharded_chunk_runner
    from kmldpc_tpu.sim.chain import ChainSpec

    per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    code = load_code(os.path.join(HERE, "assets", "PEG2304regular0.5.txt"))
    const = parse_constellation(os.path.join(HERE, "assets", "2bits_QPSK.txt"))
    spec = ChainSpec(
        code=code, constellation=const, known_h=False, fading=True,
        metric_type=False, metric_iter=5, max_iter=50,
        encoder_active=True, histogram=False,
    )
    ndev_all = len(jax.devices())
    var = np.float32(10.0 ** (-1.5))
    key = jax.random.key(0)
    base = None
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= ndev_all]
    print(f"devices available: {ndev_all} ({jax.devices()[0].platform})")
    for n in sizes:
        mesh = get_mesh(n)
        runner = make_sharded_chunk_runner(spec, per_dev * n, mesh)
        r = runner(key, var)
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        rs = [runner(jax.random.fold_in(key, i), var) for i in range(6)]
        jax.block_until_ready(rs)
        dt = (time.perf_counter() - t0) / 6
        bps = per_dev * n / dt
        if base is None:
            base = bps
        eff = bps / (base * n) * 100
        print(
            f"mesh={n:3d}  global_batch={per_dev * n:6d}  "
            f"{bps:10.0f} blk/s  efficiency {eff:6.1f}%"
        )


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "edge":
        main_edge()
    else:
        main()
