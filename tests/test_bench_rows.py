"""The bench surfaces must never rot: every row of the SHARED row matrix
(tools/rows.py) builds a valid chunk runner, and both harnesses
(bench.py, tools/microbench.py) import that one table, so a configuration
cannot be benchmarked by one surface and missed by the other.
"""

import os
import sys

import jax
import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from kmldpc_tpu.sim.chain import ChainSpec, build_chain_fn, make_chain_params
from tools.rows import CHAIN_ROWS, bench_rows, make_spec

ASSETS = os.path.join(HERE, "assets")


def _trace(spec: ChainSpec) -> None:
    params = make_chain_params(spec)
    fn = build_chain_fn(spec, batch=4)
    out = jax.eval_shape(fn, params, jax.random.key(0), np.float32(0.1))
    assert out.tot_blk.shape == ()


def test_chain_rows_build():
    assert len(CHAIN_ROWS) >= 11
    names = [r.name for r in CHAIN_ROWS]
    assert len(set(names)) == len(names), "duplicate row names"
    for r in CHAIN_ROWS:
        _trace(make_spec(r, ASSETS))


def test_bench_subset():
    rows = bench_rows()
    assert len(rows) >= 5
    assert rows[0].name == "PEG2304+QPSK/blind"  # the headline
    assert rows[1].name == "PEG2304+QPSK/known"  # its known-h A/B
    ranks = [r.bench_rank for r in rows]
    assert ranks == sorted(ranks) and len(set(ranks)) == len(ranks)


def test_harnesses_share_the_table():
    import bench
    from tools import microbench, rows

    assert microbench.CHAIN_ROWS is rows.CHAIN_ROWS
    # bench.py imports bench_rows/make_spec inside main(); pin the import
    # source by executing the module attribute lookup it performs.
    src = open(os.path.join(HERE, "bench.py")).read()
    assert "from tools.rows import" in src and "bench_rows" in src
    assert "ROWS = [" not in src  # the old second copy must not come back


def test_pick_n2_scales_fast_rows():
    """Fast rows must measure a steady-state span that dominates the fixed
    per-run cost: ~2 ms/launch rows get n2 in the hundreds, slow rows keep
    the floor, and one run stays bounded."""
    from bench import pick_n2

    assert pick_n2(0.002) >= 150  # 5G minsum-class: span >= 0.3 s
    assert pick_n2(0.008) >= 45   # cpl-folded fast chain rows
    assert pick_n2(0.065) == 12   # PEG8064-class: floor
    assert pick_n2(0.5) == 12     # very slow rows: bounded run time
    assert pick_n2(0.0) == 12     # degenerate warmup estimate
    assert pick_n2(0.0005) <= 240  # hard cap
