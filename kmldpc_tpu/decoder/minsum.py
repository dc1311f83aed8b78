"""Layered normalized min-sum LDPC decoder (LLR domain), batched.

The reference implements only flooding sum-product; layered min-sum is the
industry-standard schedule for 5G-NR LDPC (SURVEY.md section 7 step 3 calls
for it, and driver config #3 requires it).  Design:

* Posterior LLRs ``L[col]`` live column-major as [num_col, B]; check-to-
  variable messages edge-major with the batch on the minor dimension.
* One iteration sweeps the layers sequentially; within a layer all rows
  update in parallel:
      v2c   = L[col] - c2v_old
      c2v'  = alpha * sign-excl * min-excl(|v2c|)   (min1/min2 trick)
      L    += c2v' - c2v_old
* **QC fast path** (the layered schedule's reason to exist): for lifted
  codes whose decode graph is quasi-cyclic — every Z x Z block of H is a
  cyclic permutation, which holds for the shipped 5G BG2 code because its
  systematization permutation is the identity — ALL graph addressing
  reduces to static slices plus cyclic rolls.  A layer = one block-row of
  Z rows; its connection to block-column j with shift s reads
  ``roll(post[jZ:(j+1)Z], -s)`` and writes back ``roll(delta, +s)`` into
  the same static slice.  No gathers, no scatters, and the 12 layers are
  unrolled at trace time so XLA fuses across them (the previous
  ``lax.scan`` over layers with [E]-indexed gathers/scatter-adds ran
  slower than flooding).  Within a layer each column
  is touched at most once (QC property), so the slice-adds are
  conflict-free and bit-identical to a single scatter-add.
* Generic fallback (non-QC codes, or an explicit non-Z ``layer_size``):
  ``lax.scan`` over padded per-layer row tables with gathers + scatter-add.
  For unstructured codes (PEG) the default is one layer = the whole matrix
  (flooding min-sum); column conflicts within a multi-row layer would
  superimpose additively — still a valid schedule, converging slightly
  slower than a conflict-free layering.
* Early termination mirrors the flooding decoder: hard decision from L,
  syndrome check after each full sweep, per-codeword output freezing,
  while_loop exit when the whole batch converged.
* ``soft_syndrome`` is the min-sum approximation of the row-XOR
  probability: P(row XOR = 0) = sigmoid(sign_prod * min1) per row, frozen
  at convergence like the flooding decoder's exact value
  (binaryldpccodec.cc:274 computes 0.5*(1 + prod tanh(v2c/2)); min-sum
  replaces the tanh product by its min-magnitude approximation).

All generic addressing reuses the static tables compiled in code/ldpc.py.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..code.ldpc import LDPCCode
from .bp import DecodeResult, DecoderTables, channel_llr_to_columns


def _layer_tables(code: LDPCCode, layer_size: int):
    """Per-layer padded row tables: [n_layers, layer_size * drm]."""
    n_layers = (code.num_row + layer_size - 1) // layer_size
    drm = code.dr_max
    e = code.num_edges
    pad_rows = n_layers * layer_size - code.num_row
    row_edge_idx = np.concatenate(
        [code.row_edge_idx, np.full((pad_rows, drm), e, np.int32)], axis=0
    )
    row_edge_col = np.concatenate(
        [code.row_edge_col, np.full((pad_rows, drm), code.num_col, np.int32)], axis=0
    )
    row_mask = np.concatenate(
        [code.row_mask, np.zeros((pad_rows, drm), bool)], axis=0
    )
    shape = (n_layers, layer_size, drm)
    return (
        jnp.asarray(row_edge_idx.reshape(shape)),
        jnp.asarray(row_edge_col.reshape(shape)),
        jnp.asarray(row_mask.reshape(shape).astype(np.float32)),
    )


import dataclasses


def _qc_layers(code: LDPCCode) -> tuple | None:
    """Extract the quasi-cyclic block structure of the DECODE graph.

    Returns ``((z, nbc), layer_0, layer_1, ...)`` where each layer is a
    tuple of ``(block_col, shift)`` pairs — block-row i connects row r to
    column ``block_col*Z + (r + shift) % Z`` — or None when the decode
    graph (post-systematization column order, ldpc.py:186-189) is not
    exactly quasi-cyclic with the file's lifting factor.
    """
    z = code.lifting_factor
    if not z or code.num_row % z or code.num_col % z:
        return None
    br = code.edge_row // z
    bc = code.edge_col // z
    r_in = code.edge_row % z
    c_in = code.edge_col % z
    nbr, nbc = code.num_row // z, code.num_col // z
    layers = []
    # group edges by (block_row, block_col) in one pass
    key = br.astype(np.int64) * nbc + bc
    order = np.argsort(key, kind="stable")
    key_s, r_s, c_s = key[order], r_in[order], c_in[order]
    bounds = np.flatnonzero(np.diff(key_s)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [key_s.shape[0]]])
    per_layer: list[list[tuple[int, int]]] = [[] for _ in range(nbr)]
    for a, b in zip(starts, ends):
        if b - a != z:
            return None  # partial block: not a full circulant
        rr, cc = r_s[a:b], c_s[a:b]
        s = (cc - rr) % z
        if not (s == s[0]).all() or np.unique(rr).size != z:
            return None
        k = int(key_s[a])
        per_layer[k // nbc].append((k % nbc, int(s[0])))
    if any(not l for l in per_layer):
        # a block-row with no circulants would make _decode_qc stack an
        # empty list at trace time; such a degenerate layering is not QC
        return None
    return ((int(z), int(nbc)), *[tuple(l) for l in per_layer])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MinsumTables:
    """Layered-schedule tables — a pytree passed as a runtime argument (the
    layer arrays are as big as the edge set; see DecoderTables on why they
    must not become traced constants).  ``qc`` is static trace-time
    metadata (shifts per block-row layer, see :func:`_qc_layers`); when
    present the decoder takes the roll-based QC fast path and the generic
    layer arrays are unused."""

    base: DecoderTables
    l_edge_idx: jnp.ndarray  # [n_layers, ls, drm] int32
    l_edge_col: jnp.ndarray  # [n_layers, ls, drm] int32
    l_mask: jnp.ndarray  # [n_layers, ls, drm] f32
    qc: tuple | None = dataclasses.field(default=None, metadata=dict(static=True))


def minsum_tables(
    code: LDPCCode, layer_size: int | None = None, use_qc: bool = True
) -> MinsumTables:
    """``layer_size`` defaults to the lifting factor Z for 5G codes
    (conflict-free block-row layers) and to ``num_row`` (pure flooding
    min-sum) for unstructured codes.  When the decode graph is quasi-
    cyclic at the default layer size, the QC metadata enables the
    roll-based fast path; pass ``use_qc=False`` to force the generic
    gather/scatter path at the same layering (tests and benchmarks compare
    the two — no need to rebuild the frozen dataclass by hand).

    When the QC path is taken the edge-set-sized generic layer tables are
    replaced by zero-size placeholders — they would otherwise ride along
    in the pytree, wasting device memory on every instance."""
    qc = None
    if use_qc and (
        layer_size is None or (code.lifting_factor and layer_size == code.lifting_factor)
    ):
        qc = _qc_layers(code)
    if layer_size is None:
        layer_size = code.lifting_factor if code.is_5g else code.num_row
    if qc is not None:
        empty = (0, 0, 0)
        l_edge_idx = jnp.zeros(empty, jnp.int32)
        l_edge_col = jnp.zeros(empty, jnp.int32)
        l_mask = jnp.zeros(empty, jnp.float32)
    else:
        l_edge_idx, l_edge_col, l_mask = _layer_tables(code, layer_size)
    return MinsumTables(
        base=DecoderTables.from_code(code),
        l_edge_idx=l_edge_idx, l_edge_col=l_edge_col, l_mask=l_mask,
        qc=qc,
    )


def layered_minsum_decode(
    mt: MinsumTables, chan_llr: jnp.ndarray, iter_count: int, alpha: float = 0.75
) -> DecodeResult:
    """Layered min-sum decode; ``mt`` is a pytree argument.

    Dispatches to the QC roll-based fast path when ``mt.qc`` is present
    (bit-identical outputs to the generic path — same per-edge arithmetic
    in the same layer order, and min1/min2 exclusion plus the conflict-free
    column updates are order-independent within a layer); generic gather/
    scatter path otherwise.
    """
    if mt.qc is not None:
        return _decode_qc(mt, chan_llr, iter_count, alpha)
    return _decode_generic(mt, chan_llr, iter_count, alpha)


def _decode_qc(
    mt: MinsumTables, chan_llr: jnp.ndarray, iter_count: int, alpha: float
) -> DecodeResult:
    """QC fast path: static slices + cyclic rolls, layers unrolled at trace
    time (see module docstring).  c2v messages live as one [deg_l, Z, B]
    slab per layer; the posterior as [num_col, B].
    """
    t = mt.base
    (z, _nbc), *layers = mt.qc
    llr_clip = jnp.float32(constants.LLR_CLIP)
    alpha = jnp.float32(alpha)
    big = jnp.float32(1e30)
    b = chan_llr.shape[0]
    llr_col = channel_llr_to_columns(t, chan_llr.astype(jnp.float32))

    def blk(post, j):
        return jax.lax.slice_in_dim(post, j * z, (j + 1) * z)

    def sweep(post, c2v_all):
        new_all, ss_parts = [], []
        for li, layer in enumerate(layers):
            old = c2v_all[li]  # [d, z, B]
            d = len(layer)
            # row r of this block-row connects to column j*z + (r+s)%z:
            # roll(x, -s)[r] = x[(r+s) % z]
            p = jnp.stack([jnp.roll(blk(post, j), -s, axis=0) for j, s in layer])
            v2c = p - old
            sign = jnp.where(v2c < 0, -1.0, 1.0)
            mag = jnp.abs(v2c)
            min1 = jnp.min(mag, axis=0)  # [z, B]
            arg1 = jnp.argmin(mag, axis=0)
            onehot = arg1[None] == jnp.arange(d)[:, None, None]
            min2 = jnp.min(jnp.where(onehot, big, mag), axis=0)
            excl_min = jnp.where(onehot, min2[None], min1[None])
            sign_prod = jnp.prod(sign, axis=0)  # [z, B]
            new = alpha * sign_prod[None] * sign * jnp.minimum(excl_min, llr_clip)
            delta = new - old
            new_all.append(new)
            # min-sum soft syndrome: row LLR of the XOR ~ sign_prod * min1
            ss_parts.append(jax.nn.sigmoid(sign_prod * min1))
            # conflict-free column updates (each block-col at most once per
            # layer): write back through the inverse roll
            for k, (j, s) in enumerate(layer):
                post = jax.lax.dynamic_update_slice_in_dim(
                    post, blk(post, j) + jnp.roll(delta[k], s, axis=0), j * z, axis=0
                )
        return post, tuple(new_all), jnp.concatenate(ss_parts, axis=0)

    def syndrome_ok(cc_hat):  # [nc, B] int8 -> [B] bool
        oks = []
        for layer in layers:
            acc = jnp.zeros((z, b), jnp.int32)
            for j, s in layer:
                acc = acc + jnp.roll(blk(cc_hat, j), -s, axis=0).astype(jnp.int32)
            oks.append(acc % 2 == 0)
        return jnp.all(jnp.concatenate(oks, axis=0), axis=0)

    def cond(state):
        i, _, _, _, conv, _, _ = state
        return jnp.logical_and(i < iter_count, ~jnp.all(conv))

    def body(state):
        i, post, c2v, cc_hat, conv, iters, ss = state
        post, c2v, ss_new = sweep(post, c2v)
        hard = (post <= 0).astype(jnp.int8)
        cc_hat = jnp.where(conv[None, :], cc_hat, hard)
        ok = syndrome_ok(cc_hat)
        iters = iters + (~conv).astype(jnp.int32)
        conv_after = conv | ok
        ss = jnp.where(conv_after[None, :], ss, ss_new)
        # Intentional divergence from _decode_generic: post/c2v are NOT
        # frozen for converged codewords here.  Every exposed output
        # (cc_hat, iters, ss) is frozen above, so results are identical;
        # skipping the freeze saves two large selects per sweep on the hot
        # path.  If final posteriors are ever added to DecodeResult, add
        # the jnp.where(conv_after, ...) freeze here first.
        return i + 1, post, c2v, cc_hat, conv_after, iters, ss

    state = (
        jnp.int32(0),
        llr_col.T,  # [nc, B] posterior
        tuple(jnp.zeros((len(layer), z, b), jnp.float32) for layer in layers),
        jnp.zeros((t.num_col, b), jnp.int8),
        jnp.zeros((b,), bool),
        jnp.zeros((b,), jnp.int32),
        jnp.ones((t.num_row, b), jnp.float32),
    )
    _, _, _, cc_hat, conv, iters, ss = jax.lax.while_loop(cond, body, state)
    uu_hat = jax.lax.dynamic_slice_in_dim(cc_hat, t.info_start, t.code_dim, 0)
    return DecodeResult(uu_hat.T, cc_hat.T, conv, iters, ss.T)


def _decode_generic(
    mt: MinsumTables, chan_llr: jnp.ndarray, iter_count: int, alpha: float
) -> DecodeResult:
    t = mt.base
    l_edge_idx, l_edge_col, l_mask = mt.l_edge_idx, mt.l_edge_col, mt.l_mask
    n_layers, ls, drm = l_edge_idx.shape
    llr_clip = jnp.float32(constants.LLR_CLIP)
    alpha = jnp.float32(alpha)
    big = jnp.float32(1e30)
    b = chan_llr.shape[0]
    # row-major -> slot-major column index of each row slot (syndrome check)
    row_col_sm = t.row_edge_col.T.reshape(-1)  # [drm*nr], num_col = pad

    def sweep(carry, layer):
        post_pad, c2v_pad = carry  # [nc+1, B], [E+1, B]
        edge_idx, edge_col, mask = layer  # [ls, drm] each
        idx_flat = edge_idx.reshape(-1)
        col_flat = edge_col.reshape(-1)
        old = c2v_pad[idx_flat].reshape(ls, drm, b)
        v2c = post_pad[col_flat].reshape(ls, drm, b) - old
        mask3 = mask[:, :, None]
        mag = jnp.abs(v2c)
        mag_m = jnp.where(mask3 > 0, mag, big)
        # min1/min2 exclusion over the row (drm) axis
        min1 = jnp.min(mag_m, axis=1, keepdims=True)
        arg1 = jnp.argmin(mag_m, axis=1)  # [ls, B]
        onehot = jax.nn.one_hot(arg1, drm, dtype=mag_m.dtype, axis=1)
        min2 = jnp.min(mag_m + onehot * big, axis=1, keepdims=True)
        excl_min = jnp.where(onehot > 0, min2, min1)
        sign = jnp.where(v2c < 0, -1.0, 1.0)
        sign = jnp.where(mask3 > 0, sign, 1.0)
        sign_prod = jnp.prod(sign, axis=1, keepdims=True)
        new = alpha * sign_prod * sign * jnp.minimum(excl_min, llr_clip)
        new = new * mask3
        delta = (new - old) * mask3
        # scatter: posterior[col] += delta; c2v[edge] = new (row scatters;
        # pad slots hit the pad rows, which are re-zeroed by `set` and
        # ignored by downstream gathers)
        post_pad = post_pad.at[col_flat].add(delta.reshape(-1, b))
        c2v_pad = c2v_pad.at[idx_flat].set(new.reshape(-1, b))
        # min-sum soft syndrome (same approximation as the QC path):
        # P(row XOR = 0) ~ sigmoid(sign_prod * min1); pad rows give
        # sigmoid(big) = 1 and are sliced off after the scan.
        ss_layer = jax.nn.sigmoid(sign_prod[:, 0] * min1[:, 0])  # [ls, B]
        return (post_pad, c2v_pad), ss_layer

    llr_col = channel_llr_to_columns(t, chan_llr.astype(jnp.float32))
    post0 = jnp.concatenate([llr_col.T, jnp.zeros((1, b), jnp.float32)], axis=0)
    c2v0 = jnp.zeros((t.num_edges + 1, b), jnp.float32)
    cc0 = jnp.zeros((t.num_col, b), jnp.int8)
    conv0 = jnp.zeros((b,), bool)
    iters0 = jnp.zeros((b,), jnp.int32)
    ss0 = jnp.ones((t.num_row, b), jnp.float32)

    def syndrome_ok(hard):
        hard_pad = jnp.concatenate([hard, jnp.zeros((1, b), jnp.int8)], axis=0)
        hard_edge = hard_pad[row_col_sm].reshape(drm, t.num_row, b)
        parity = jnp.sum(hard_edge.astype(jnp.int32), axis=0) % 2
        return jnp.all(parity == 0, axis=0)

    def cond(state):
        i, _, _, _, conv, _, _ = state
        return jnp.logical_and(i < iter_count, ~jnp.all(conv))

    def body(state):
        i, post, c2v, cc_hat, conv, iters, ss = state
        (post_new, c2v_new), ss_layers = jax.lax.scan(
            sweep, (post, c2v), (l_edge_idx, l_edge_col, l_mask)
        )
        ss_new = ss_layers.reshape(n_layers * ls, b)[: t.num_row]
        # pad row of the posterior must stay 0 (scatter-adds accumulate there)
        post_new = post_new.at[-1].set(0.0)
        hard = (post_new[:-1] <= 0).astype(jnp.int8)
        cc_hat = jnp.where(conv[None, :], cc_hat, hard)
        ok = syndrome_ok(cc_hat)
        iters = iters + (~conv).astype(jnp.int32)
        conv_after = conv | ok
        # post/c2v freeze: the QC path intentionally skips this (see note
        # there) — outputs are identical because cc_hat/iters/ss above are
        # frozen either way.
        post = jnp.where(conv_after[None, :], post, post_new)
        c2v = jnp.where(conv_after[None, :], c2v, c2v_new)
        ss = jnp.where(conv_after[None, :], ss, ss_new)
        return i + 1, post, c2v, cc_hat, conv_after, iters, ss

    state = (jnp.int32(0), post0, c2v0, cc0, conv0, iters0, ss0)
    _, _, _, cc_hat, conv, iters, ss = jax.lax.while_loop(cond, body, state)
    uu_hat = jax.lax.dynamic_slice_in_dim(cc_hat, t.info_start, t.code_dim, 0)
    return DecodeResult(uu_hat.T, cc_hat.T, conv, iters, ss.T)


_jitted_minsum = jax.jit(layered_minsum_decode, static_argnums=(2, 3))


def make_layered_minsum_decoder(
    code: LDPCCode,
    alpha: float = 0.75,
    layer_size: int | None = None,
) -> Callable[[jnp.ndarray, int], DecodeResult]:
    """Standalone decoder bound to one code's tables (test use)."""
    mt = minsum_tables(code, layer_size)

    def decode(chan_llr: jnp.ndarray, iter_count: int) -> DecodeResult:
        return _jitted_minsum(mt, chan_llr, iter_count, alpha)

    decode.tables = mt  # type: ignore[attr-defined]
    return decode
