"""Statistical BER/FER parity check: this framework vs. the C++ reference.

Usage:
    python tools/parity.py <reference.log> <ours.json>
    python tools/parity.py --all      # re-judge every committed CI pair

Parses the reference's final per-SNR counter lines
(``SNR = x Total blk = n Error blk = e Error bit = eb ...``) and our
sweep-result JSON, then runs two-proportion z-tests per SNR point for both
FER (error blocks / total blocks) and BER (error bits / total bits).

Monte-Carlo parity criterion (BASELINE.md): every point within statistical
error — here |z| < 4 (two-sided ~6e-5 per point) with a sane caveat for
near-zero-error points.
"""

from __future__ import annotations

import json
import math
import re
import sys

LINE = re.compile(
    r"SNR = (?P<snr>-?[\d.]+) Total blk =\s*(?P<tot>\d+) "
    r"Error blk = \s*(?P<eblk>\d+) Error bit = \s*(?P<ebit>\d+)"
)


def parse_reference_log(path: str, info_bits_per_blk: int | None = None) -> dict[float, dict]:
    """Last counter line per SNR wins (they are cumulative)."""
    out: dict[float, dict] = {}
    for line in open(path):
        m = LINE.search(line)
        if m:
            snr = float(m.group("snr"))
            out[snr] = dict(
                tot_blk=int(m.group("tot")),
                err_blk=int(m.group("eblk")),
                err_bit=int(m.group("ebit")),
            )
    return out


def ztest(k1: int, n1: int, k2: int, n2: int) -> float:
    """Two-proportion z statistic (pooled)."""
    if n1 == 0 or n2 == 0:
        return 0.0
    p1, p2 = k1 / n1, k2 / n2
    p = (k1 + k2) / (n1 + n2)
    if p in (0.0, 1.0):
        return 0.0
    se = math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    return (p1 - p2) / se


def compare(ref: dict[float, dict], ours: list[dict], info_bits: int) -> list[dict]:
    rows = []
    for o in ours:
        snr = o["snr"]
        r = ref.get(snr)
        if r is None:
            continue
        z_fer = ztest(r["err_blk"], r["tot_blk"], o["err_blk"], o["tot_blk"])
        # Bit errors are clustered within blocks (a failed block flips a
        # large fraction of its bits), so an iid-bit z-test wildly
        # overstates significance.  Treat blocks as the sampling unit with
        # per-block wrong-bit fraction x_i (E[x] = BER).  When the sweep
        # recorded the empirical second moment (ChunkResult.err_bit_sq =
        # sum of per-block err-bit counts squared), use the measured
        # variance of x — under H0 both sides share the distribution, so it
        # serves both: se^2 = v * (1/n1 + 1/n2).  Old result files without
        # the field fall back to the conservative bound
        # E[x^2] <= x_max * E[x], x_max = 0.6 (decode failures flip at most
        # ~60% of info bits in practice).
        n1, n2 = r["tot_blk"], o["tot_blk"]
        b1 = r["err_bit"] / (n1 * info_bits)
        b2 = o["err_bit"] / o["tot_bit"]
        if o.get("err_bit_sq"):
            ex2 = o["err_bit_sq"] / (n2 * info_bits * info_bits)
            v = max(ex2 - b2 * b2, 0.0)
            var = v / n1 + v / n2
        else:
            x_max = 0.6
            var = (max(x_max * b1 - b1 * b1, 0.0) / n1
                   + max(x_max * b2 - b2 * b2, 0.0) / n2)
        z_ber = (b1 - b2) / math.sqrt(var) if var > 0 else 0.0
        rows.append(
            dict(
                snr=snr,
                ref_fer=r["err_blk"] / r["tot_blk"],
                our_fer=o["err_blk"] / o["tot_blk"],
                z_fer=z_fer,
                ref_ber=r["err_bit"] / (r["tot_blk"] * info_bits),
                our_ber=o["err_bit"] / o["tot_bit"],
                z_ber=z_ber,
            )
        )
    return rows


def run_all() -> int:
    """Re-judge EVERY committed (reference log, ours JSON) pair — the CI
    pair table of tests/test_parity_logs.py — and print one worst-|z|
    line per pair.  Exit 0 iff all pass."""
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    from tests.test_parity_logs import PAIRS, PARITY_DIR

    worst_all = 0.0
    for ours_f, ref_f, info_bits in PAIRS:
        ref = parse_reference_log(os.path.join(PARITY_DIR, ref_f))
        ours = json.load(open(os.path.join(PARITY_DIR, ours_f)))
        rows = compare(ref, ours, info_bits)
        worst = max(max(abs(r["z_fer"]), abs(r["z_ber"])) for r in rows)
        worst_all = max(worst_all, worst)
        print(f"{ours_f:44s} vs {ref_f:30s} worst |z| = {worst:4.2f}")
    ok = worst_all < 4.0
    print(f"{len(PAIRS)} pairs, overall worst |z| = {worst_all:.2f} -> "
          f"{'PASS' if ok else 'FAIL'} (threshold 4)")
    return 0 if ok else 1


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--all":
        return run_all()
    ref_log, ours_json = sys.argv[1], sys.argv[2]
    ref = parse_reference_log(ref_log)
    ours = json.load(open(ours_json))
    if len(sys.argv) > 3:
        info_bits = int(sys.argv[3])
    else:
        # the reference counts err_bit over K info bits per block; infer K
        # from our sweep's counters (tot_bit = tot_blk * K)
        info_bits = round(ours[0]["tot_bit"] / ours[0]["tot_blk"])
    rows = compare(ref, ours, info_bits)
    worst = 0.0
    print(f"{'SNR':>6} {'ref FER':>10} {'our FER':>10} {'z':>6}   {'ref BER':>10} {'our BER':>10} {'z':>6}")
    for r in rows:
        print(
            f"{r['snr']:6.2f} {r['ref_fer']:10.5f} {r['our_fer']:10.5f} {r['z_fer']:6.2f}   "
            f"{r['ref_ber']:10.6f} {r['our_ber']:10.6f} {r['z_ber']:6.2f}"
        )
        worst = max(worst, abs(r["z_fer"]), abs(r["z_ber"]))
    ok = worst < 4.0
    print(f"worst |z| = {worst:.2f} -> {'PASS' if ok else 'FAIL'} (threshold 4)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
