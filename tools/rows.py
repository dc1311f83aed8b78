"""Single source of truth for the chain benchmark row matrix.

Both bench surfaces — ``bench.py`` (the headline run) and
``tools/microbench.py`` (the per-component harness) — import THIS table:
one definition, one naming scheme (``CODE+MOD/mode[/variant]``), so a
configuration cannot be covered by one surface and missed by the other.

Row order is most-important-first (a run cut by its time limit still
measures the rows that matter; results flush incrementally).
``bench_rank`` orders the subset bench.py runs: rank 0 is the headline
(blind PEG2304+QPSK — the reference's flagship mode, simulator.cc:111-169),
rank 1 its known-h A/B, later ranks yield to the wall-clock budget.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


@dataclasses.dataclass(frozen=True)
class ChainRow:
    name: str  # canonical: CODE+MOD/mode[/variant]
    code: str  # asset file names
    modem: str
    known_h: bool
    schedule: str
    snr_db: float
    metric_type: bool = False
    # None -> harness default (batch 1024, chunks_per_launch 16; bench.py
    # additionally honors the KMLDPC_BENCH_BATCH / _CPL env overrides)
    batch: int | None = None
    cpl: int | None = None
    extra: dict = dataclasses.field(default_factory=dict)
    bench_rank: int | None = None  # None = microbench-only row


CHAIN_ROWS = [
    # round 4: metric_prune skips the exactly-tied complement candidates
    # (QPSK + even-degree rows), halving the blind metric stage — the
    # selected h is unchanged (exact counter-equality pinned by test)
    ChainRow("PEG2304+QPSK/blind/prune", "PEG2304regular0.5.txt",
             "2bits_QPSK.txt", False, "flooding", 15.0,
             extra={"metric_prune": True}),
    ChainRow("PEG2304+QPSK/blind/fminsum-prune", "PEG2304regular0.5.txt",
             "2bits_QPSK.txt", False, "flooding-minsum", 15.0,
             extra={"metric_schedule": "match", "metric_prune": True},
             bench_rank=7),
    # min-sum CN rule on the flooding schedule — the compute lever the
    # PEG8064 roofline analysis identifies (no transcendental phi passes);
    # statistical parity only (PARITY.md sweep 8)
    ChainRow("PEG8064+64QAM/known/fminsum", "PEG8064regular0.5.txt",
             "6bits_64QAM_Gray.txt", True, "flooding-minsum", 18.0, cpl=1),
    # batch 1024: measured 2.1-2.7x over batch 256 (the decoder while-loop
    # amortizes per-launch and per-iteration fixed cost over more lanes)
    ChainRow("PEG8064+64QAM/known", "PEG8064regular0.5.txt",
             "6bits_64QAM_Gray.txt", True, "flooding", 18.0, cpl=1),
    ChainRow("PEG8064+64QAM/blind/fminsum", "PEG8064regular0.5.txt",
             "6bits_64QAM_Gray.txt", False, "flooding-minsum", 18.0, cpl=1,
             extra={"metric_schedule": "match"}, bench_rank=6),
    ChainRow("PEG8064+64QAM/blind", "PEG8064regular0.5.txt",
             "6bits_64QAM_Gray.txt", False, "flooding", 18.0, cpl=1,
             bench_rank=5),
    # metric_schedule="match": the 4 candidate metric decodes use the QC
    # min-sum fast path too (opt-in extension; the default metric decode
    # stays flooding for reference parity)
    ChainRow("5G+16QAM/blind/hard/minsum", "5GLDPCBG2a3_R12_K960.txt",
             "4bit_16QAM_Gray.txt", False, "layered-minsum", 18.0, cpl=4,
             extra={"metric_schedule": "match"}, bench_rank=3),
    # opt-in bfloat16 message storage — the HBM-bandwidth lever for the
    # same roofline; statistical parity only (PARITY.md sweep 6)
    ChainRow("PEG8064+64QAM/known/bf16", "PEG8064regular0.5.txt",
             "6bits_64QAM_Gray.txt", True, "flooding", 18.0, cpl=1,
             extra={"dtype": "bfloat16"}),
    # flooding min-sum on the classic PEG2304 chain: the decoder bench
    # shows this core compute-bound (250 -> 152 us/iter), so unlike
    # PEG8064 the rule pays at full batch too
    ChainRow("PEG2304+QPSK/blind/fminsum", "PEG2304regular0.5.txt",
             "2bits_QPSK.txt", False, "flooding-minsum", 15.0,
             extra={"metric_schedule": "match"}),
    ChainRow("PEG2304+QPSK/known/fminsum", "PEG2304regular0.5.txt",
             "2bits_QPSK.txt", True, "flooding-minsum", 15.0),
    # the headline: the reference's flagship blind mode
    ChainRow("PEG2304+QPSK/blind", "PEG2304regular0.5.txt", "2bits_QPSK.txt",
             False, "flooding", 15.0, bench_rank=0),
    ChainRow("PEG2304+QPSK/known", "PEG2304regular0.5.txt", "2bits_QPSK.txt",
             True, "flooding", 15.0, bench_rank=1),
    ChainRow("5G+16QAM/known/flooding", "5GLDPCBG2a3_R12_K960.txt",
             "4bit_16QAM_Gray.txt", True, "flooding", 18.0, cpl=4,
             bench_rank=4),
    ChainRow("5G+16QAM/known/minsum", "5GLDPCBG2a3_R12_K960.txt",
             "4bit_16QAM_Gray.txt", True, "layered-minsum", 18.0, cpl=4,
             bench_rank=2),
    ChainRow("5G+16QAM/blind/hard", "5GLDPCBG2a3_R12_K960.txt",
             "4bit_16QAM_Gray.txt", False, "flooding", 18.0, cpl=4),
]


def bench_rows() -> list[ChainRow]:
    """The driver-bench subset, in bench_rank order (headline first)."""
    rows = [r for r in CHAIN_ROWS if r.bench_rank is not None]
    return sorted(rows, key=lambda r: r.bench_rank)


def pick_n2(est_sec: float, n1: int = 4) -> int:
    """Size a slope measurement's long run from the per-call estimate so
    the steady-state span dominates the fixed per-run cost (pipeline fill
    and drain, the final sync) even for the fastest rows.

    Targets a (n2 - n1) span >= 0.35 s, floor 12 calls, capped so one run
    stays under ~6 s.  Shared by bench.measure() and microbench.steady().
    """
    if est_sec <= 0:
        return 12
    n2 = n1 + max(8, int(0.35 / est_sec + 1))
    n2 = min(n2, max(12, int(6.0 / est_sec)))
    return max(12, min(n2, 240))


def make_spec(row: ChainRow, assets_dir: str, dtype: str = "float32",
              max_iter: int = 50) -> Any:
    """Build the row's ChainSpec (row.extra wins over the dtype default)."""
    from kmldpc_tpu.code import load_code
    from kmldpc_tpu.io import parse_constellation
    from kmldpc_tpu.sim.chain import ChainSpec

    code = load_code(os.path.join(assets_dir, row.code))
    const = parse_constellation(os.path.join(assets_dir, row.modem))
    kwargs = {"dtype": dtype}
    kwargs.update(row.extra)
    return ChainSpec(
        code=code, constellation=const, known_h=row.known_h, fading=True,
        metric_type=row.metric_type, metric_iter=5, max_iter=max_iter,
        encoder_active=True, histogram=False, schedule=row.schedule,
        **kwargs,
    )
