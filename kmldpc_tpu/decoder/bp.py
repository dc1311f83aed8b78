"""Flooding sum-product LDPC decoder, batched over codewords.

Behavioral parity with ``BinaryLDPCCodec::Decoder`` (binaryldpccodec.cc:
164-278) and the 5G override (binary5gldpccodec.cc:112-232), re-derived as
a batched array program:

* The reference iterates probability-domain 2-state trellis sweeps per
  variable/check node with per-step normalization and a final clip of every
  check-to-variable message into [1e-12, 1-1e-12].  Normalization cancels in
  probability *ratios*, so the identical computation in the log-likelihood-
  ratio domain is: variable nodes sum LLRs, check nodes apply the tanh rule,
  and the clip becomes |c2v| <= log((1-1e-12)/1e-12) = LLR_CLIP.
* Check-node magnitudes use the self-inverse Gallager function
  phi(x) = -log tanh(x/2) = log1p(e^-x) - log1p(-e^-x):
  |c2v_e| = phi( sum_{e' != e} phi(|v2c_e'|) ), which stays accurate in f32
  where a direct tanh-product would saturate at 1.
* Early termination per codeword (the reference breaks out of the iteration
  loop at the first passing syndrome, *before* the check-node update) becomes
  mask-freezing: hard decisions and the soft syndrome are frozen at the
  iteration where the syndrome first passed, and a `lax.while_loop` exits
  when every codeword in the batch has converged.
* The per-iteration order matches the reference exactly: VN update → hard
  decision → syndrome check (→ break) → CN update.
* 5G puncturing: the first 2Z columns carry prior LLR 0 (probability 0.5,
  binary5gldpccodec.cc:126-129) and channel LLRs are offset by 2Z.

The addressing scheme is gather-only (no scatters): messages live in a
[B, E] array in column-sorted edge order; per-column groups are gathered via
``col_edge_idx`` and per-row groups via ``row_edge_idx``; the check-node
results are written back by gathering with ``edge_rowslot``.  All tables are
static (compiled in code/ldpc.py), so XLA sees fixed-shape fused loops.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..code.ldpc import LDPCCode

# Guard for phi(0)=inf. Must stay >= ~1e-6: below that, exp(-x) rounds to
# exactly 1.0 in f32 and log1p(-exp(-x)) returns -inf, which turns the
# check-node self-exclusion into inf - inf = NaN.
_PHI_ARG_MIN = 1e-6


def phi(x: jnp.ndarray) -> jnp.ndarray:
    """Gallager's self-inverse phi(x) = -log tanh(x/2), f32-stable for x > 0.

    Piecewise: for small x, tanh is computed directly (no cancellation); for
    large x, tanh(x/2) rounds to 1.0 in f32, so use
    phi(x) = log1p(e^-x) - log1p(-e^-x), whose difference is ~2e^-x with full
    relative precision.  Each branch's input is clamped so neither produces
    inf in the untaken branch.
    """
    small = -jnp.log(jnp.tanh(jnp.minimum(x, 5.0) * 0.5))
    e = jnp.exp(-jnp.maximum(x, 5.0))
    large = jnp.log1p(e) - jnp.log1p(-e)
    return jnp.where(x < 5.0, small, large)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DecoderTables:
    """Graph tables for one code — a pytree whose arrays are passed to the
    jitted programs as *arguments*, never closed over.

    Embedding them as trace-time constants would inflate the serialized
    program by megabytes (PEG8064's tables alone are ~350k integers); as
    runtime parameters the program stays small and one compilation serves
    every code with the same shapes.
    """

    num_col: int = dataclasses.field(metadata=dict(static=True))
    num_row: int = dataclasses.field(metadata=dict(static=True))
    num_edges: int = dataclasses.field(metadata=dict(static=True))
    code_dim: int = dataclasses.field(metadata=dict(static=True))
    punct: int = dataclasses.field(metadata=dict(static=True))
    is_5g: bool = dataclasses.field(metadata=dict(static=True))
    info_start: int = dataclasses.field(metadata=dict(static=True))
    # Regular-code fast path (see bp_em._decode_cols_regular): constant
    # column degree dc / row degree dr make both groupings pure reshapes;
    # only the interleaver permutation remains as gathers.
    dc: int = dataclasses.field(metadata=dict(static=True))  # 0 if irregular
    dr: int = dataclasses.field(metadata=dict(static=True))  # 0 if irregular
    edge_col: jnp.ndarray  # [E] int32
    col_edge_idx: jnp.ndarray  # [num_col, dcm] int32 (E = pad)
    row_edge_idx: jnp.ndarray  # [num_row, drm] int32 (E = pad)
    row_mask: jnp.ndarray  # [num_row, drm] f32 (1 = real edge)
    edge_rowslot: jnp.ndarray  # [E] int32 into flattened [num_row*drm]
    row_edge_col: jnp.ndarray  # [num_row, drm] int32 (num_col = pad)
    # Slot-major permutations for the bp_em decoder: with messages stored
    # [deg, nodes, B], merging the two leading axes is a free reshape (no
    # retiling), so these are the only data movement.
    # perm_sm_r2c[p] = slot-major col-flat index of the edge at slot-major
    # row-flat position p; perm_sm_c2r is the inverse. For irregular codes
    # the slot arrays are padded to (dcm, drm): pad positions point at some
    # valid index and are neutralized by the masks below.
    perm_sm_r2c: jnp.ndarray  # [drm*num_row] int32
    perm_sm_c2r: jnp.ndarray  # [dcm*num_col] int32
    col_mask_sm: jnp.ndarray  # [dcm, num_col] f32 — 1 where a real edge
    row_mask_sm: jnp.ndarray  # [drm, num_row] f32
    # Degree-class (dense) layout for irregular codes — see
    # bp_em._decode_cols_classes.  Columns/rows are sorted ascending by
    # degree; each degree class d with n nodes owns a contiguous
    # [d * n] span of one flat [E] message space (slot-major within the
    # class), so there are ZERO pad slots — the 5G BG2 code wastes 61%
    # of its column slots in the padded layout above.
    col_classes: tuple = dataclasses.field(metadata=dict(static=True))  # ((d, n), ...)
    row_classes: tuple = dataclasses.field(metadata=dict(static=True))
    col_sort: jnp.ndarray = None  # [nc] int32 — sorted pos -> original column
    col_unsort: jnp.ndarray = None  # [nc] int32 — original column -> sorted pos
    row_unsort: jnp.ndarray = None  # [nr] int32 — original row -> sorted pos
    perm_cf_r2c: jnp.ndarray = None  # [E] int32 — row-flat pos -> col-flat idx
    perm_cf_c2r: jnp.ndarray = None  # [E] int32 — col-flat pos -> row-flat idx
    row_col_cf: jnp.ndarray = None  # [E] int32 — row-flat pos -> sorted col idx

    @property
    def is_regular(self) -> bool:
        return self.dc > 0

    @staticmethod
    def from_code(code: LDPCCode) -> "DecoderTables":
        info_start = 0 if code.is_5g else code.code_chk
        regular = bool(code.col_mask.all() and code.row_mask.all())
        dcm, drm = code.dc_max, code.dr_max
        cls = _build_class_tables(code)
        # slot-major flat positions of each real edge
        # col side: edge e (col-sorted) sits at column edge_col[e], slot =
        # its rank within the column
        col_of = code.edge_col.astype(np.int64)
        slot_c = np.zeros(code.num_edges, dtype=np.int64)
        seen: dict[int, int] = {}
        for e in range(code.num_edges):
            c = int(col_of[e])
            slot_c[e] = seen.get(c, 0)
            seen[c] = slot_c[e] + 1
        col_sm = slot_c * code.num_col + col_of
        r = (code.edge_rowslot // drm).astype(np.int64)
        s = (code.edge_rowslot % drm).astype(np.int64)
        row_sm = s * code.num_row + r
        # pad positions point at index 0 and are neutralized by the masks
        perm_sm_r2c = np.zeros(drm * code.num_row, dtype=np.int32)
        perm_sm_r2c[row_sm] = col_sm.astype(np.int32)
        perm_sm_c2r = np.zeros(dcm * code.num_col, dtype=np.int32)
        perm_sm_c2r[col_sm] = row_sm.astype(np.int32)
        col_mask_sm = np.zeros(dcm * code.num_col, dtype=np.float32)
        col_mask_sm[col_sm] = 1.0
        row_mask_sm = np.zeros(drm * code.num_row, dtype=np.float32)
        row_mask_sm[row_sm] = 1.0
        return DecoderTables(
            num_col=code.num_col,
            num_row=code.num_row,
            num_edges=code.num_edges,
            code_dim=code.code_dim,
            punct=code.punct,
            is_5g=code.is_5g,
            info_start=info_start,
            dc=code.dc_max if regular else 0,
            dr=code.dr_max if regular else 0,
            edge_col=jnp.asarray(code.edge_col),
            col_edge_idx=jnp.asarray(code.col_edge_idx),
            row_edge_idx=jnp.asarray(code.row_edge_idx),
            row_mask=jnp.asarray(code.row_mask.astype(np.float32)),
            edge_rowslot=jnp.asarray(code.edge_rowslot),
            row_edge_col=jnp.asarray(code.row_edge_col),
            perm_sm_r2c=jnp.asarray(perm_sm_r2c),
            perm_sm_c2r=jnp.asarray(perm_sm_c2r),
            col_mask_sm=jnp.asarray(col_mask_sm.reshape(dcm, code.num_col)),
            row_mask_sm=jnp.asarray(row_mask_sm.reshape(drm, code.num_row)),
            **cls,
        )


def _class_layout(degrees: np.ndarray):
    """Sort nodes ascending by degree and assign each node's edge slots a
    contiguous flat index span per degree class.

    Returns (classes, sort, unsort, slot_base, stride) where ``classes`` is
    ``((degree, count), ...)``, ``sort[p]`` is the original node at sorted
    position p, ``unsort`` its inverse, and slot s of a node sits at flat
    index ``slot_base[node] + s * stride[node]`` (slot_base pre-folds the
    class offset and the node's rank within its class; stride is the class
    node count).
    """
    sort = np.argsort(degrees, kind="stable").astype(np.int32)
    unsort = np.empty_like(sort)
    unsort[sort] = np.arange(sort.shape[0], dtype=np.int32)
    degs, counts = np.unique(degrees, return_counts=True)
    classes = tuple((int(d), int(n)) for d, n in zip(degs, counts))
    # per-node: flat index of slot s = off_k + s * n_k + (unsort[node] - base_k)
    base = np.zeros(len(classes), dtype=np.int64)
    off = np.zeros(len(classes), dtype=np.int64)
    acc_n, acc_e = 0, 0
    for k, (d, n) in enumerate(classes):
        base[k], off[k] = acc_n, acc_e
        acc_n += n
        acc_e += d * n
    cls_of = np.searchsorted(degs, degrees)  # [nodes]
    slot_base = off[cls_of] - base[cls_of] + unsort.astype(np.int64)
    stride = np.asarray([n for _, n in classes], dtype=np.int64)[cls_of]
    return classes, sort, unsort, slot_base, stride


def _build_class_tables(code: LDPCCode) -> dict:
    """Dense degree-class tables (see DecoderTables doc) from the code graph."""
    nc, nr, e = code.num_col, code.num_row, code.num_edges
    cd = np.bincount(code.edge_col, minlength=nc)
    rd = np.bincount(code.edge_row, minlength=nr)
    ccls, csort, cunsort, cslot_base, cstride = _class_layout(cd)
    rcls, _, runsort, rslot_base, rstride = _class_layout(rd)

    # edges are column-sorted, so the slot (rank within column) is positional
    col_starts = np.cumsum(cd) - cd
    slot_c = np.arange(e, dtype=np.int64) - col_starts[code.edge_col]
    colflat = cslot_base[code.edge_col] + slot_c * cstride[code.edge_col]
    slot_r = (code.edge_rowslot % code.dr_max).astype(np.int64)
    rowflat = rslot_base[code.edge_row] + slot_r * rstride[code.edge_row]

    perm_cf_r2c = np.empty(e, dtype=np.int32)
    perm_cf_r2c[rowflat] = colflat.astype(np.int32)
    perm_cf_c2r = np.empty(e, dtype=np.int32)
    perm_cf_c2r[colflat] = rowflat.astype(np.int32)
    row_col_cf = np.empty(e, dtype=np.int32)
    row_col_cf[rowflat] = cunsort[code.edge_col]
    return dict(
        col_classes=ccls,
        row_classes=rcls,
        col_sort=jnp.asarray(csort),
        col_unsort=jnp.asarray(cunsort),
        row_unsort=jnp.asarray(runsort),
        perm_cf_r2c=jnp.asarray(perm_cf_r2c),
        perm_cf_c2r=jnp.asarray(perm_cf_c2r),
        row_col_cf=jnp.asarray(row_col_cf),
    )


class DecodeResult(NamedTuple):
    uu_hat: jnp.ndarray  # [B, K] int8
    cc_hat: jnp.ndarray  # [B, num_col] int8 — full-codeword hard decision
    converged: jnp.ndarray  # [B] bool — syndrome passed within iter budget
    iters: jnp.ndarray  # [B] int32 — VN iterations executed per codeword
    soft_syndrome: jnp.ndarray  # [B, num_row] f32 — frozen at convergence


def channel_llr_to_columns(t: DecoderTables, chan_llr: jnp.ndarray) -> jnp.ndarray:
    """Map transmitted-position LLRs to graph columns (5G puncture insert)."""
    if t.punct == 0:
        return chan_llr
    b = chan_llr.shape[0]
    zeros = jnp.zeros((b, t.punct), dtype=chan_llr.dtype)
    return jnp.concatenate([zeros, chan_llr], axis=1)


def count_failed_checks(t: DecoderTables, bits: jnp.ndarray) -> jnp.ndarray:
    """Number of unsatisfied parity checks of a [B, num_col] 0/1 word.

    Mirrors ``BinaryLDPCCodec::ParityCheck`` (binaryldpccodec.cc:280-299).
    """
    bits_pad = jnp.concatenate(
        [bits.astype(jnp.int32), jnp.zeros((bits.shape[0], 1), jnp.int32)], axis=1
    )
    per_row = bits_pad[:, t.row_edge_col]  # [B, num_row, drm]
    parity = jnp.sum(per_row, axis=-1) % 2
    return jnp.sum(parity, axis=-1).astype(jnp.int32)


def flooding_decode(
    t: DecoderTables, chan_llr: jnp.ndarray, iter_count: int
) -> DecodeResult:
    """Flooding BP decode; ``t`` is a pytree argument (see DecoderTables).

    chan_llr: [B, tx_len] f32 — LLR log(P0/P1) per transmitted bit.
    iter_count must be static (python int) per jit specialization.
    """
    llr_clip = jnp.float32(constants.LLR_CLIP)

    def vn_pass(c2v: jnp.ndarray, llr_col: jnp.ndarray):
        b = c2v.shape[0]
        c2v_pad = jnp.concatenate([c2v, jnp.zeros((b, 1), c2v.dtype)], axis=1)
        per_col = c2v_pad[:, t.col_edge_idx]  # [B, num_col, dcm]
        colsum = jnp.sum(per_col, axis=-1)  # [B, num_col]
        post = llr_col + colsum
        v2c = post[:, t.edge_col] - c2v
        # reference: bit 0 iff alpha0 > alpha1, i.e. LLR > 0; ties -> 1
        hard = (post <= 0).astype(jnp.int8)
        return v2c, hard

    def syndrome_ok(hard: jnp.ndarray):
        b = hard.shape[0]
        hard_pad = jnp.concatenate(
            [hard.astype(jnp.int32), jnp.zeros((b, 1), jnp.int32)], axis=1
        )
        per_row = hard_pad[:, t.row_edge_col]
        parity = jnp.sum(per_row, axis=-1) % 2
        return jnp.all(parity == 0, axis=-1)

    def cn_pass(v2c: jnp.ndarray):
        b = v2c.shape[0]
        v2c_pad = jnp.concatenate([v2c, jnp.zeros((b, 1), v2c.dtype)], axis=1)
        per_row = v2c_pad[:, t.row_edge_idx]  # [B, num_row, drm]
        sign = jnp.where(per_row < 0, -1.0, 1.0)
        sign = jnp.where(t.row_mask > 0, sign, 1.0)
        mag = jnp.maximum(jnp.abs(per_row), _PHI_ARG_MIN)
        ph = jnp.where(t.row_mask > 0, phi(mag), 0.0)
        phi_sum = jnp.sum(ph, axis=-1)  # [B, num_row]
        sign_prod = jnp.prod(sign, axis=-1)  # [B, num_row]
        excl_phi = jnp.maximum(phi_sum[:, :, None] - ph, constants.SMALLEST_PROB)
        excl_sign = sign_prod[:, :, None] * sign
        c2v_row = excl_sign * jnp.minimum(phi(excl_phi), llr_clip)
        c2v_new = c2v_row.reshape(b, -1)[:, t.edge_rowslot]
        # soft syndrome: alpha0 of the full row trellis = P(row XOR = 0)
        # = (1 + prod tanh(v2c/2)) / 2  (binaryldpccodec.cc:274).
        ss = 0.5 * (1.0 + sign_prod * jnp.exp(-phi_sum))
        return c2v_new, ss

    b = chan_llr.shape[0]
    llr_col = channel_llr_to_columns(t, chan_llr.astype(jnp.float32))

    c2v0 = jnp.zeros((b, t.num_edges), jnp.float32)
    cc0 = jnp.zeros((b, t.num_col), jnp.int8)
    conv0 = jnp.zeros((b,), bool)
    iters0 = jnp.zeros((b,), jnp.int32)
    ss0 = jnp.ones((b, t.num_row), jnp.float32)

    def cond(state):
        i, _, _, conv, _, _ = state
        return jnp.logical_and(i < iter_count, ~jnp.all(conv))

    def body(state):
        i, c2v, cc_hat, conv, iters, ss = state
        v2c, hard = vn_pass(c2v, llr_col)
        # freeze hard decisions of already-converged codewords
        cc_hat = jnp.where(conv[:, None], cc_hat, hard)
        ok = syndrome_ok(cc_hat)
        iters = iters + (~conv).astype(jnp.int32)
        conv_after = conv | ok
        c2v_new, ss_new = cn_pass(v2c)
        # reference skips the CN update once converged (break before it)
        c2v = jnp.where(conv_after[:, None], c2v, c2v_new)
        ss = jnp.where(conv_after[:, None], ss, ss_new)
        return i + 1, c2v, cc_hat, conv_after, iters, ss

    state = (jnp.int32(0), c2v0, cc0, conv0, iters0, ss0)
    _, _, cc_hat, conv, iters, ss = jax.lax.while_loop(cond, body, state)
    uu_hat = jax.lax.dynamic_slice_in_dim(cc_hat, t.info_start, t.code_dim, 1)
    return DecodeResult(uu_hat, cc_hat, conv, iters, ss)


_jitted_flooding = jax.jit(flooding_decode, static_argnums=2)


def make_flooding_decoder(
    code: LDPCCode,
) -> Callable[[jnp.ndarray, int], DecodeResult]:
    """Standalone decoder bound to one code's tables (test/metric use).

    The tables are passed to the jitted program as runtime arguments — not
    baked in as constants — so the compiled artifact stays small and is
    shared across codes with identical table shapes.
    """
    t = DecoderTables.from_code(code)

    def decode(chan_llr: jnp.ndarray, iter_count: int) -> DecodeResult:
        return _jitted_flooding(t, chan_llr, iter_count)

    decode.tables = t  # type: ignore[attr-defined]
    return decode
