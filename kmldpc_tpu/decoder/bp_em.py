"""Edge-major flooding BP: the production layout of decoder/bp.py.

Same algorithm and semantics as ``flooding_decode`` (LLR-domain tanh-rule
flooding with the reference's clip/freeze behavior — see bp.py), but every
message array is stored **edge-major** with the Monte-Carlo batch on the
minor (contiguous) dimension, so all graph addressing is gathers of whole
*rows* of B values — contiguous row copies, not per-element gathers.

Messages live in ONE array: c2v in **row(-slot) layout**, the layout the
check-node update naturally produces.  v2c never exists as a stored array —
it is recomputed as ``post[col(e)] - c2v[e]`` inside the CN pass.  Per
iteration that leaves exactly two gathers:

  1. edge gather: c2v (row-flat [E, B]) -> column-grouped view, reduced to
     column posteriors ``post = llr + colsum``.
  2. node gather: ``post`` ([num_col, B]) broadcast to row-grouped edges;
     one gather serves both the syndrome check (``post_edge <= 0``) and the
     on-the-fly ``v2c = post_edge - c2v``.

(A column-major c2v would pay a third edge-sized permute to materialize
v2c in row order.)  Converged codewords freeze
their *outputs* (hard decisions, iteration counts, soft syndromes); the
message array itself keeps updating — all messages are clipped finite, so
the frozen outputs are unaffected and the per-iteration freeze copy of the
[E, B] state is saved.

The public entry transposes [B, tx] -> [tx, B] on the way in and back on
the way out, so callers see the same interface as bp.flooding_decode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants
from .bp import DecodeResult, DecoderTables, phi

_PHI_ARG_MIN = 1e-6


def flooding_decode_em(
    t: DecoderTables,
    chan_llr: jnp.ndarray,
    iter_count: int,
    msg_dtype=jnp.float32,
    cn_rule: str = "sumprod",
    alpha: float = 0.75,
) -> DecodeResult:
    """Drop-in replacement for bp.flooding_decode (same result semantics).

    ``msg_dtype`` selects the storage dtype of the c2v/v2c message arrays
    (node arithmetic stays f32).  float32 is the reference-parity path;
    bfloat16 halves message bandwidth at statistically — not bitwise —
    equivalent BER/FER (see PARITY.md).

    ``cn_rule`` selects the check-node update: "sumprod" (reference-parity
    Gallager-phi tanh rule) or "minsum" (normalized min-sum with factor
    ``alpha``, the same per-edge arithmetic as decoder/minsum.py but on the
    flooding schedule).  Min-sum replaces the two transcendental phi passes
    with min1/min2 vector reductions; it is an
    opt-in extension (``[tpu].schedule = "flooding-minsum"``) validated
    statistically, not bitwise, against the reference.
    """
    llr_tx = chan_llr.astype(jnp.float32).T  # [tx, B]
    res = _decode_cols(
        t, _insert_punct(t, llr_tx), iter_count, msg_dtype, cn_rule, alpha
    )
    return DecodeResult(
        res.uu_hat.T, res.cc_hat.T, res.converged, res.iters, res.soft_syndrome.T
    )


def _insert_punct(t: DecoderTables, llr_tx: jnp.ndarray) -> jnp.ndarray:
    if t.punct:
        b = llr_tx.shape[1]
        return jnp.concatenate([jnp.zeros((t.punct, b), jnp.float32), llr_tx], axis=0)
    return llr_tx


def _decode_cols(
    t: DecoderTables, llr_col: jnp.ndarray, iter_count: int,
    msg_dtype=jnp.float32, cn_rule: str = "sumprod", alpha: float = 0.75,
) -> DecodeResult:
    """Column-major core dispatch: regular codes use the padded slot-major
    loop below; irregular codes use the dense degree-class loop
    (:func:`_decode_cols_classes`), which carries zero pad slots."""
    if cn_rule not in ("sumprod", "minsum"):
        raise ValueError(f"unknown cn_rule {cn_rule!r}")
    if not t.is_regular:
        return _decode_cols_classes(t, llr_col, iter_count, msg_dtype, cn_rule, alpha)
    return _decode_cols_padded(t, llr_col, iter_count, msg_dtype, cn_rule, alpha)


def _cn_minsum(v2c: jnp.ndarray, mask, alpha: float, llr_clip):
    """Normalized min-sum check-node update over the leading (slot) axis.

    ``v2c``: [d, n, B] f32; ``mask``: [d, n, 1] (1 = real edge) or None for
    regular codes.  Returns (c2v_new [d, n, B], soft_syndrome [n, B]).
    Same per-edge arithmetic as decoder/minsum.py (min1/min2 exclusion,
    sign product, alpha normalization, sigmoid soft syndrome), applied on
    the flooding schedule.
    """
    big = jnp.float32(1e30)
    d = v2c.shape[0]
    sign = jnp.where(v2c < 0, -1.0, 1.0)
    mag = jnp.abs(v2c)
    if mask is not None:
        sign = jnp.where(mask > 0, sign, 1.0)
        mag = jnp.where(mask > 0, mag, big)
    min1 = jnp.min(mag, axis=0)  # [n, B]
    arg1 = jnp.argmin(mag, axis=0)
    onehot = arg1[None] == jnp.arange(d)[:, None, None]
    min2 = jnp.min(jnp.where(onehot, big, mag), axis=0)
    excl_min = jnp.where(onehot, min2[None], min1[None])
    sign_prod = jnp.prod(sign, axis=0)  # [n, B]
    c2v_new = jnp.float32(alpha) * sign_prod[None] * sign * jnp.minimum(
        excl_min, llr_clip
    )
    if mask is not None:
        c2v_new = c2v_new * mask
    # min-sum soft syndrome: row LLR of the XOR ~ sign_prod * min1
    return c2v_new, jax.nn.sigmoid(sign_prod * min1)


def _cn_sumprod(v2c: jnp.ndarray, mask, llr_clip):
    """Gallager-phi (tanh-rule) check-node update over the leading axis.

    Same contract as :func:`_cn_minsum`: ``v2c`` [d, n, B] f32, ``mask``
    [d, n, 1] (1 = real edge) or None; returns (c2v_new, soft_syndrome).
    Shared by the padded slot-major core and the edge-sharded decoder
    (parallel/edge_sharded.py) so the two cannot drift."""
    sign = jnp.where(v2c < 0, -1.0, 1.0)
    mag = jnp.maximum(jnp.abs(v2c), _PHI_ARG_MIN)
    ph = phi(mag)
    if mask is not None:
        sign = jnp.where(mask > 0, sign, 1.0)
        ph = ph * mask
    phi_sum = jnp.sum(ph, axis=0)  # [n, B]
    sign_prod = jnp.prod(sign, axis=0)
    excl_phi = jnp.maximum(phi_sum[None, :, :] - ph, constants.SMALLEST_PROB)
    excl_sign = sign_prod[None, :, :] * sign
    c2v_new = excl_sign * jnp.minimum(phi(excl_phi), llr_clip)
    ss_new = 0.5 * (1.0 + sign_prod * jnp.exp(-phi_sum))
    return c2v_new, ss_new


def _decode_cols_classes(
    t: DecoderTables, llr_col: jnp.ndarray, iter_count: int,
    msg_dtype=jnp.float32, cn_rule: str = "sumprod", alpha: float = 0.75,
) -> DecodeResult:
    """Degree-class flooding core for irregular codes — same semantics as
    :func:`_decode_cols_padded` / bp.flooding_decode, dense message layout.

    The padded slot-major layout stores [d_max, nodes, B] message blocks;
    for the 5G BG2 code (col degrees 1..9, mean 3.5) 61% of the column
    slots and 36% of the row slots are padding, and every per-iteration
    pass pays that bandwidth.  Here columns and rows are sorted by degree
    (a one-time [nc]/[nr] permutation of the LLR input and hard/soft
    outputs) and c2v messages live in one flat dense row-flat [E, B] array
    in which each degree class d owns a contiguous [d * n_k, B] span,
    viewed as [d, n_k, B] for the node reductions — zero padding anywhere.
    Per iteration only two gathers move data across classes: c2v row-flat
    -> col-flat for the column reduction, and the [nc, B] posteriors ->
    row-flat edges (serving both the syndrome check and the on-the-fly
    ``v2c = post_edge - c2v``; see the module docstring).
    """
    llr_clip = jnp.float32(constants.LLR_CLIP)
    b = llr_col.shape[1]
    nc, nr = t.num_col, t.num_row
    e = t.num_edges
    llr_s = llr_col[t.col_sort]  # degree-sorted column order

    def body(state):
        i, c2v, cc_hat, conv, iters, ss = state  # c2v: [E, B] row-flat
        # --- VN per column class on the col-flat gathered view ---
        c2v_col = c2v[t.perm_cf_c2r]  # [E, B] col-flat
        posts = []
        off = base = 0
        for d, n in t.col_classes:
            blk = jax.lax.slice_in_dim(c2v_col, off, off + d * n)
            blk = blk.reshape(d, n, b).astype(jnp.float32)
            posts.append(
                jax.lax.slice_in_dim(llr_s, base, base + n) + jnp.sum(blk, axis=0)
            )
            off += d * n
            base += n
        post = jnp.concatenate(posts, axis=0)  # [nc, B] sorted
        hard = (post <= 0).astype(jnp.int8)
        cc_hat = jnp.where(conv[None, :], cc_hat, hard)
        # --- node gather: posteriors to row-flat edges ---
        post_edge = post[t.row_col_cf]  # [E, B] f32
        # --- syndrome from the gathered posteriors (bit-identical to
        # gathering the hard bits: (post <= 0) commutes with the gather) ---
        parts = []
        roff = 0
        for d, n in t.row_classes:
            pe = jax.lax.slice_in_dim(post_edge, roff, roff + d * n).reshape(d, n, b)
            parts.append(jnp.sum((pe <= 0).astype(jnp.int32), axis=0) % 2)
            roff += d * n
        parity = jnp.concatenate(parts, axis=0)  # [nr, B] sorted
        ok = jnp.all(parity == 0, axis=0)
        iters = iters + (~conv).astype(jnp.int32)
        conv_after = conv | ok
        # --- CN per row class; v2c recomputed in place ---
        news, sss = [], []
        roff = 0
        for d, n in t.row_classes:
            pe = jax.lax.slice_in_dim(post_edge, roff, roff + d * n).reshape(d, n, b)
            ce = (
                jax.lax.slice_in_dim(c2v, roff, roff + d * n)
                .reshape(d, n, b)
                .astype(jnp.float32)
            )
            blk = pe - ce  # v2c for this row class
            if cn_rule == "minsum":
                new, ss_blk = _cn_minsum(blk, None, alpha, llr_clip)
            else:
                new, ss_blk = _cn_sumprod(blk, None, llr_clip)
            news.append(new.astype(msg_dtype).reshape(d * n, b))
            sss.append(ss_blk)
            roff += d * n
        c2v = jnp.concatenate(news, axis=0)  # [E, B] row-flat
        ss_new = jnp.concatenate(sss, axis=0)  # [nr, B] sorted
        ss = jnp.where(conv_after[None, :], ss, ss_new)
        return i + 1, c2v, cc_hat, conv_after, iters, ss

    def cond(state):
        i, _, _, conv, _, _ = state
        return jnp.logical_and(i < iter_count, ~jnp.all(conv))

    state = (
        jnp.int32(0),
        jnp.zeros((e, b), msg_dtype),
        jnp.zeros((nc, b), jnp.int8),
        jnp.zeros((b,), bool),
        jnp.zeros((b,), jnp.int32),
        jnp.ones((nr, b), jnp.float32),
    )
    _, _, cc_hat, conv, iters, ss = jax.lax.while_loop(cond, body, state)
    cc_orig = cc_hat[t.col_unsort]  # undo the degree sort
    ss_orig = ss[t.row_unsort]
    uu_hat = jax.lax.dynamic_slice_in_dim(cc_orig, t.info_start, t.code_dim, 0)
    return DecodeResult(uu_hat, cc_orig, conv, iters, ss_orig)


def _decode_cols_padded(
    t: DecoderTables, llr_col: jnp.ndarray, iter_count: int,
    msg_dtype=jnp.float32, cn_rule: str = "sumprod", alpha: float = 0.75,
) -> DecodeResult:
    """Slot-major core loop on column-major LLRs [num_col, B].

    c2v messages live row-slot-major as [dr_max, num_row, B]; per-node
    reductions run over the leading axis and flattening for the gathers is
    a free major-dim merge.  Per iteration: one edge gather (c2v -> column
    view), one node gather (posteriors -> row slots), and v2c recomputed as
    ``post_edge - c2v`` inside the CN pass (module docstring).  Irregular
    codes use the same path with pad slots neutralized by masks (zero
    contribution on the column side, sign=+1 / phi=0 on the row side); for
    regular codes the masks are all-ones and the mask multiplies are
    skipped.
    """
    llr_clip = jnp.float32(constants.LLR_CLIP)
    b = llr_col.shape[1]
    dcm = t.col_mask_sm.shape[0]
    drm = t.row_mask_sm.shape[0]
    nc, nr = t.num_col, t.num_row
    regular = t.is_regular
    cmask = t.col_mask_sm[:, :, None]  # [dcm, nc, 1]
    rmask = t.row_mask_sm[:, :, None]  # [drm, nr, 1]
    row_col_sm = t.row_edge_col.T.reshape(-1)  # [drm*nr] col of each slot, nc = pad

    def body(state):
        i, c2v, cc_hat, conv, iters, ss = state  # c2v: [drm, nr, B] msg_dtype
        # --- VN on the column-gathered view ---
        c2v_col = c2v.reshape(-1, b)[t.perm_sm_c2r].reshape(dcm, nc, b)
        c2v_col = c2v_col.astype(jnp.float32)
        if not regular:
            c2v_col = c2v_col * cmask  # pad slots gathered garbage -> 0
        post = llr_col + jnp.sum(c2v_col, axis=0)  # [nc, B]
        hard = (post <= 0).astype(jnp.int8)
        cc_hat = jnp.where(conv[None, :], cc_hat, hard)
        # --- node gather: posteriors to row slots (pad columns index the
        # appended +1 row: hard 0, no parity contribution, masked in CN) ---
        if regular:
            post_edge = post[row_col_sm].reshape(drm, nr, b)
        else:
            post_pad = jnp.concatenate([post, jnp.ones((1, b), jnp.float32)], axis=0)
            post_edge = post_pad[row_col_sm].reshape(drm, nr, b)
        parity = jnp.sum((post_edge <= 0).astype(jnp.int32), axis=0) % 2
        ok = jnp.all(parity == 0, axis=0)
        iters = iters + (~conv).astype(jnp.int32)
        conv_after = conv | ok
        # --- CN; v2c recomputed in place ---
        v2c_row = post_edge - c2v.astype(jnp.float32)
        cn = _cn_minsum if cn_rule == "minsum" else _cn_sumprod
        cn_args = (alpha, llr_clip) if cn_rule == "minsum" else (llr_clip,)
        c2v_new, ss_new = cn(v2c_row, None if regular else rmask, *cn_args)
        c2v = c2v_new.astype(msg_dtype)
        ss = jnp.where(conv_after[None, :], ss, ss_new)
        return i + 1, c2v, cc_hat, conv_after, iters, ss

    def cond(state):
        i, _, _, conv, _, _ = state
        return jnp.logical_and(i < iter_count, ~jnp.all(conv))

    state = (
        jnp.int32(0),
        jnp.zeros((drm, nr, b), msg_dtype),
        jnp.zeros((nc, b), jnp.int8),
        jnp.zeros((b,), bool),
        jnp.zeros((b,), jnp.int32),
        jnp.ones((nr, b), jnp.float32),
    )
    _, _, cc_hat, conv, iters, ss = jax.lax.while_loop(cond, body, state)
    uu_hat = jax.lax.dynamic_slice_in_dim(cc_hat, t.info_start, t.code_dim, 0)
    return DecodeResult(uu_hat, cc_hat, conv, iters, ss)


def two_phase_generic(
    decode,
    chan_llr: jnp.ndarray,
    iter_count: int,
    phase1_iters: int = 8,
    tile: int = 128,
) -> DecodeResult:
    """Exact two-phase wrapper for ANY deterministic batch decoder.

    ``decode(chan_llr, iter_count) -> DecodeResult`` with batch-major
    arrays.  Same argument as :func:`flooding_decode_two_phase`: converged
    codewords already hold the full decoder's exact result; the unconverged
    minority is compacted into tiles and re-decoded from scratch, giving
    bit-identical outputs at a fraction of the batched cost.  Used for the
    layered min-sum schedule (decoder/minsum.py).
    """
    b = chan_llr.shape[0]
    tile = min(max(8, tile), b)
    if tile >= b or phase1_iters >= iter_count:
        return decode(chan_llr, iter_count)

    p1 = decode(chan_llr, phase1_iters)
    order = jnp.argsort(p1.converged, stable=True)
    n_unconv = jnp.sum(~p1.converged).astype(jnp.int32)

    def tile_cond(state):
        return state[0] * tile < n_unconv

    def tile_body(state):
        k, uu_hat, cc_hat, conv, iters, ss = state
        start = jnp.minimum(k * tile, b - tile)
        idx = jax.lax.dynamic_slice_in_dim(order, start, tile)
        sub = decode(chan_llr[idx], iter_count)
        return (
            k + 1,
            uu_hat.at[idx].set(sub.uu_hat),
            cc_hat.at[idx].set(sub.cc_hat),
            conv.at[idx].set(sub.converged),
            iters.at[idx].set(sub.iters),
            ss.at[idx].set(sub.soft_syndrome),
        )

    state = (jnp.int32(0), p1.uu_hat, p1.cc_hat, p1.converged, p1.iters, p1.soft_syndrome)
    _, uu_hat, cc_hat, conv, iters, ss = jax.lax.while_loop(tile_cond, tile_body, state)
    return DecodeResult(uu_hat, cc_hat, conv, iters, ss)


def flooding_decode_two_phase(
    t: DecoderTables,
    chan_llr: jnp.ndarray,
    iter_count: int,
    phase1_iters: int = 12,
    tile: int = 128,
    msg_dtype=jnp.float32,
    cn_rule: str = "sumprod",
    alpha: float = 0.75,
) -> DecodeResult:
    """Exact two-phase flooding decode — bit-identical to
    :func:`flooding_decode_em`, usually several times cheaper.

    At any SNR where Monte-Carlo needs many blocks, almost every codeword
    converges within ~10 iterations, but the batched while_loop costs
    max-iterations on the *whole* batch as long as one codeword is live.
    Phase 1 therefore runs ``phase1_iters`` on the full batch; phase 2
    compacts the still-unconverged codewords into ``tile``-sized sub-batches
    (argsort of the converged mask, dynamic tile loop over however many
    tiles are needed) and re-decodes each from scratch with the full
    ``iter_count`` budget.  BP is deterministic, so a codeword that
    converged at iteration k <= phase1_iters already has exactly the result
    the full decoder would produce, and a re-decoded codeword follows
    exactly the full decoder's trajectory — the outputs (including iteration
    counts and frozen soft syndromes) are identical, only the schedule of
    wasted work changes.  Worst case (nothing converges early: deep
    waterfall SNR) costs one extra phase1_iters sweep.
    """
    b = chan_llr.shape[0]
    tile = min(max(8, tile), b)
    if tile >= b or phase1_iters >= iter_count:
        # tiny batches / budgets: compaction buys nothing, run single-phase
        return flooding_decode_em(t, chan_llr, iter_count, msg_dtype, cn_rule, alpha)
    llr_col = _insert_punct(t, chan_llr.astype(jnp.float32).T)

    p1 = _decode_cols(t, llr_col, phase1_iters, msg_dtype, cn_rule, alpha)

    # unconverged-first ordering; stable so tiles are deterministic
    order = jnp.argsort(p1.converged, stable=True)  # False (unconverged) first
    n_unconv = jnp.sum(~p1.converged).astype(jnp.int32)

    def tile_cond(state):
        k = state[0]
        return k * tile < n_unconv

    def tile_body(state):
        k, cc_hat, conv, iters, ss = state
        start = jnp.minimum(k * tile, b - tile)
        idx = jax.lax.dynamic_slice_in_dim(order, start, tile)  # [tile]
        sub = _decode_cols(t, llr_col[:, idx], iter_count, msg_dtype, cn_rule, alpha)
        cc_hat = cc_hat.at[:, idx].set(sub.cc_hat)
        conv = conv.at[idx].set(sub.converged)
        iters = iters.at[idx].set(sub.iters)
        ss = ss.at[:, idx].set(sub.soft_syndrome)
        return k + 1, cc_hat, conv, iters, ss

    state = (jnp.int32(0), p1.cc_hat, p1.converged, p1.iters, p1.soft_syndrome)
    _, cc_hat, conv, iters, ss = jax.lax.while_loop(tile_cond, tile_body, state)
    uu_hat = jax.lax.dynamic_slice_in_dim(cc_hat, t.info_start, t.code_dim, 0)
    return DecodeResult(uu_hat.T, cc_hat.T, conv, iters, ss.T)
