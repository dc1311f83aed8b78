"""Phase-ambiguity resolution: metric evaluation over the 4 ĥ candidates.

Reference: ``KmCodec::{GetMetrics, Metric, GetParityCheck}``
(kmcodec.cc:105-163).  For each candidate ĥ_k the codeword is soft-demapped
with uniform bit priors and a metric is computed:

* soft (``metric_type = true``): run the BP decoder ``metric_iter``
  iterations, metric = Σ_rows log(soft_syndrome) — then |·| is taken and
  the candidate with the *smallest* |metric| wins (kmcodec.cc:147-155 and
  the abs at kmcodec.cc:140).
* hard, classic codec (``metric_type = false``): NO decoding — the
  demapped P(bit=0) is hard-decided with the reference's inverted
  convention (rr = 1 when P0 > 0.5, kmcodec.cc:109-114 — harmless for
  even-degree rows, replicated verbatim) and the metric is the number of
  failed parity checks of rr.
* hard, 5G codec: run the decoder ``metric_iter`` iterations first, then
  count failed checks of the decoder's hard codeword (kmcodec.cc:156-159,
  106-107).

Ties resolve to the first minimum (std::min_element == jnp.argmin).

Inherent ambiguity note (parity-relevant): for QPSK the constellation is
closed under negation with *complemented* labels, and every PEG row has even
degree, so the complement of a codeword is a codeword — the ĥ and -ĥ
candidates produce exactly tied metrics (hard counts identical; soft metrics
identical up to rounding).  Neither the reference nor this implementation
can resolve the 180° ambiguity for QPSK + even-degree codes; both fall back
to first-minimum tie-breaking.  16QAM Gray labeling is not complement-closed
under negation, so all four rotations separate there.

The 4 candidates are folded into the batch dimension, so metric decodes run
as one [4B]-batched decoder call.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..code.ldpc import LDPCCode
from ..decoder.bp import DecoderTables, count_failed_checks
from ..decoder.bp_em import flooding_decode_em as flooding_decode
from ..io.constellation import Constellation
from ..ops.modem import ModemTables, make_soft_demapper


def complement_closed(code: LDPCCode, c: Constellation) -> bool:
    """True iff the ĥ and -ĥ metric candidates are exactly tied IN f32.

    Three conditions (see the inherent-ambiguity note above): negating
    every constellation point lands on the point with the bitwise-
    COMPLEMENTED label (so demapping under -h complements every bit
    decision), every check row has even degree (so the complement of a
    codeword is a codeword and its syndrome/soft-syndrome is identical),
    and the table has at most 4 points.  The size bound is what lifts the
    mathematical tie to a bit-exact f32 tie: with <= 4 points each demap
    bit class holds at most 2 points, so the per-bit logsumexp over the
    permuted distances is a 2-term sum — commutative-exact in f32.  A
    larger complement-closed table would permute >2-term sums whose f32
    results can differ by an ulp, and an ulp at a P0 == 0.5 boundary
    could let the unpruned path pick -ĥ and flip a whole block (the
    advisor's round-4 finding).  When all three hold, candidates 2 and 3
    (= -1 and -j rotations) tie candidates 0 and 1 exactly and
    ``std::min_element`` / ``jnp.argmin`` first-minimum tie-breaking can
    NEVER select them — which is what makes ``prune_complement`` (skip
    computing them) selection-equivalent.  The shipped 2bits_QPSK table
    satisfies this; 16QAM Gray and the shipped 4PSK table do not (their
    negation is not label-complementing — checked programmatically, never
    assumed), and the 5G codes have odd-degree rows.
    """
    if c.num_points > 4:
        # mathematical closure would not imply the bit-exact f32 tie that
        # selection equivalence requires (docstring); no shipped table
        # above 4 points is complement-closed anyway
        return False
    pts = np.asarray(c.points)
    bits = np.asarray(c.bits)
    for k in range(c.num_points):
        d = np.abs(pts + pts[k])  # nearest point to -pts[k]
        j = int(np.argmin(d))
        if d[j] > 1e-9 or not np.array_equal(bits[j], 1 - bits[k]):
            return False
    row_deg = np.asarray(code.row_mask).sum(axis=1)
    return bool((row_deg % 2 == 0).all())


def make_ambiguity_selector(
    code: LDPCCode,
    tables: ModemTables,
    metric_type: bool,
    metric_iter: int,
    decode=None,
    prune_complement: bool = False,
    metric_fn=None,
) -> Callable[..., tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """Returns ``select(t, yr, yi, h4_r, h4_i, var) -> (hr, hi, metrics)``.

    ``t`` is the code's DecoderTables pytree (runtime argument, see bp.py);
    yr/yi: [B, Nsym]; h4_*: [B, 4] candidates.  Output: the winning
    candidate per codeword ([B] each) and the raw |metric| table [B, 4]
    (used by histogram mode).

    ``decode`` overrides the metric decoder: a callable
    ``decode(t, chan_llr, metric_iter) -> DecodeResult`` where ``t`` is
    whatever table pytree the caller passes to ``select`` (the parity check
    count uses ``t.base`` when present, e.g. MinsumTables).  Default: the
    reference-parity flooding decoder (kmcodec.cc:147-159 runs the same BP
    as the final decode).  The chain passes the layered min-sum decoder
    here under ``[tpu].metric_schedule = "match"`` — an extension: the
    reference has no min-sum at all, so there is no reference behavior to
    diverge from, but the default stays "flooding" to keep blind sweeps
    comparable to the C++ simulator.

    ``metric_fn`` replaces the whole metric computation:
    ``metric_fn(t, bit_p0, chan_llr) -> metric [B_folded]`` (PRE-abs values,
    the GetMetrics semantics of kmcodec.cc:105-163) over the
    candidate-folded batch.  The model-parallel runner
    (parallel/edge_sharded.py) injects a row-sharded implementation here so
    the metric decodes' message state is partitioned like the final
    decode's — without it the 4-candidate metric stage would keep full
    per-device message state, exactly the peak the feature exists to
    remove.  Mutually exclusive with ``decode``.
    """
    demap = make_soft_demapper(tables)
    needs_decode = metric_type or code.is_5g
    if metric_fn is not None and decode is not None:
        raise ValueError("metric_fn and decode are mutually exclusive")
    if decode is None:
        decode = lambda t, llr, it: flooding_decode(t, llr, it)
    # prune_complement: candidates 2,3 (-1, -j rotations) exactly tie 0,1
    # (see complement_closed) and first-minimum tie-breaking can never
    # select them, so skip computing them — half the demap/metric work.
    # The caller is responsible for checking complement_closed first.
    nc = 2 if prune_complement else 4

    def select(t, yr, yi, h4_r, h4_i, var):
        """Returns (hr, hi, metrics, llr_best).

        ``llr_best`` is the winning candidate's channel LLRs, reused by the
        caller for the final decode — the reference re-demaps with ĥ*
        (kmcodec.cc:70), which recomputes exactly the winning candidate's
        demap output, so reusing it is value-identical and one demap
        cheaper.
        """
        b, nsym = yr.shape
        # fold candidates into the batch: [B, nc, Nsym] -> [nc*B, Nsym]
        yrn = jnp.broadcast_to(yr[:, None, :], (b, nc, nsym)).reshape(b * nc, nsym)
        yin = jnp.broadcast_to(yi[:, None, :], (b, nc, nsym)).reshape(b * nc, nsym)
        hrn = h4_r[:, :nc].reshape(b * nc)
        hin = h4_i[:, :nc].reshape(b * nc)
        bit_p0, chan_llr = demap(yrn, yin, hrn, hin, var)

        dec_tabs = getattr(t, "base", t)  # MinsumTables carries .base
        if metric_fn is not None:
            metric = metric_fn(t, bit_p0, chan_llr)
        elif not needs_decode:
            # classic hard metric: inverted hard decision of the demap
            # output, no decoding (kmcodec.cc:109-114).
            rr = (bit_p0 > 0.5).astype(jnp.int8)  # NOTE: P(bit=0) > 0.5 -> 1
            metric = count_failed_checks(dec_tabs, rr).astype(jnp.float32)
        else:
            res = decode(t, chan_llr, metric_iter)
            if metric_type:
                # sum of log soft-syndromes (kmcodec.cc:147-155)
                metric = jnp.sum(jnp.log(res.soft_syndrome), axis=-1)
            else:
                metric = count_failed_checks(dec_tabs, res.cc_hat).astype(jnp.float32)
        metrics = jnp.abs(metric).reshape(b, nc)  # abs: kmcodec.cc:140
        best = jnp.argmin(metrics, axis=1)  # first min, like std::min_element
        oh = jax.nn.one_hot(best, nc, dtype=h4_r.dtype)
        hr = jnp.sum(h4_r[:, :nc] * oh, axis=1)
        hi = jnp.sum(h4_i[:, :nc] * oh, axis=1)
        # winner's LLRs via a row gather of the folded [nc*B, n] array
        rows = jnp.arange(b, dtype=jnp.int32) * nc + best.astype(jnp.int32)
        llr_best = chan_llr[rows]
        if prune_complement:
            # the skipped candidates' metrics equal the computed ones (that
            # is the pruning condition); report the tied values so the
            # [B, 4] surface (debug chatter) keeps its shape
            metrics = jnp.concatenate([metrics, metrics], axis=1)
        return hr, hi, metrics, llr_best

    return select
