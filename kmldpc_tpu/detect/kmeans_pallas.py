"""Blind k-means on the GPU: the whole estimate in one Pallas kernel.

The plain estimator (detect/kmeans.py) builds the [B, Nsym, M] distance
tensor and its one-hot assignment on each of its iterations, and XLA does
not fuse across the iterations of a ``fori_loop``, so every iteration
writes and reads those tensors in device memory.  This kernel keeps the
whole loop inside one program per received block (one row of y):

    init (max-|y| anchor)  ->  loop (at most ``iters`` times):
        walk the row in power-of-two column chunks:
            assignment: [chunk, M] squared distances to the clusters s_k·ĥ,
                        first minimum per symbol
            per-cluster counts and sums: masked column reductions
        centroid + re-anchoring (constellation re-projection)  ->  ĥ

and writes only the final gain.  A row is at most a few KB, so after the
first pass the chunks come from the cache, not from device memory.  The
route is Triton: the work is masked elementwise code and reductions with
no matrix product.  The grid has one program per row and no order; the
constellation is a small operand, padded to a power of two and masked.

Reference semantics preserved (kmeans.cc:14-84, intended form — see
detect/kmeans.py for the documented quirk divergences, including the
anchor-scale fix: the anchored centroid divides by its OWN constellation
point, not unconditionally by s0): max-|y| init anchored to the
max-modulus point, nearest-cluster assignment with first-minimum ties,
count-0-safe centroid, "max" (or verbatim de-facto "first") anchor
re-projection, empty-anchor keeps the previous gain.

Early exit: ĥ -> assignment -> ĥ is a deterministic map, so once an
iteration leaves ĥ bit-unchanged every later iteration would too.  A
program stops there, which is bit-identical to running all ``iters``
iterations; only that row's own program waits for it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Elements of one [chunk, M] step: 32 f32 values per thread at 4 warps.
_STEP_ELEMS = 4096
_NUM_WARPS = 4


def chunk_layout(nsym: int, m_points: int) -> tuple[int, int]:
    """``(chunk, m_pad)``: the power-of-two column chunk a program walks its
    row in, and the constellation size padded to a power of two."""
    m_pad = pl.next_power_of_2(m_points)
    chunk = max(1, min(pl.next_power_of_2(nsym), _STEP_ELEMS // m_pad))
    return chunk, m_pad


def _kmeans_kernel(yr_ref, yi_ref, pr_ref, pi_ref, hr_ref, hi_ref, *,
                   nsym: int, chunk: int, m_points: int, iters: int,
                   anchor: str, init_pt: tuple, early_exit: bool):
    m_pad = pr_ref.shape[0]
    pr = pr_ref[...]  # [m_pad], zero past m_points
    pi = pi_ref[...]
    midx = jnp.arange(m_pad)
    mvalid = midx < m_points
    n_chunks = pl.cdiv(nsym, chunk)

    def load(c):
        col = c * chunk + jnp.arange(chunk)
        ok = col < nsym
        yr = plgpu.load(yr_ref.at[col], mask=ok, other=0.0)
        yi = plgpu.load(yi_ref.at[col], mask=ok, other=0.0)
        return col, ok, yr, yi

    # --- init: the symbol with max |y| (first index on ties, like argmax),
    # anchored to the init constellation point ---
    def init_step(c, st):
        best, by_r, by_i = st
        col, ok, yr, yi = load(c)
        mag = jnp.where(ok, yr * yr + yi * yi, -1.0)
        cmax = jnp.max(mag)
        sel = col == jnp.min(jnp.where(mag == cmax, col, nsym))
        take = cmax > best  # strict: an earlier chunk keeps its tie
        return (
            jnp.where(take, cmax, best),
            jnp.where(take, jnp.sum(jnp.where(sel, yr, 0.0)), by_r),
            jnp.where(take, jnp.sum(jnp.where(sel, yi, 0.0)), by_i),
        )

    f0 = jnp.float32(0.0)
    _, ymax_r, ymax_i = jax.lax.fori_loop(
        0, n_chunks, init_step, (jnp.float32(-1.0), f0, f0)
    )
    s_r, s_i, s_norm = init_pt
    h_r0 = (ymax_r * s_r + ymax_i * s_i) / s_norm
    h_i0 = (ymax_i * s_r - ymax_r * s_i) / s_norm

    def update(h_r, h_i):
        cr = h_r * pr - h_i * pi  # clusters s_k·ĥ: [m_pad]
        ci = h_r * pi + h_i * pr

        def stats(c, acc):
            cnt, sum_r, sum_i = acc
            _, ok, yr, yi = load(c)
            dre = yr[:, None] - cr[None, :]
            dim = yi[:, None] - ci[None, :]
            d = jnp.where(mvalid[None, :], dre * dre + dim * dim, jnp.inf)
            dmin = jnp.min(d, axis=1, keepdims=True)
            # first minimum (jnp.argmin / std::min_element ties)
            k = jnp.min(jnp.where(d == dmin, midx[None, :], m_pad), axis=1,
                        keepdims=True)
            hit = (midx[None, :] == k) & ok[:, None]  # [chunk, m_pad]
            return (
                cnt + jnp.sum(hit.astype(jnp.float32), axis=0),
                sum_r + jnp.sum(jnp.where(hit, yr[:, None], 0.0), axis=0),
                sum_i + jnp.sum(jnp.where(hit, yi[:, None], 0.0), axis=0),
            )

        zeros = jnp.zeros((m_pad,), jnp.float32)
        cnt, sum_r, sum_i = jax.lax.fori_loop(
            0, n_chunks, stats, (zeros, zeros, zeros)
        )
        safe = jnp.maximum(cnt, 1.0)
        cent_r = sum_r / safe
        cent_i = sum_i / safe
        if anchor == "first":
            # de-facto reference: cluster 0 / s_0 (kmeans.cc:65-73)
            pick = midx == 0
        else:
            cmag = jnp.where(cnt > 0, cent_r * cent_r + cent_i * cent_i, -1.0)
            pick = midx == jnp.min(jnp.where(cmag == jnp.max(cmag), midx, m_pad))
        a_r = jnp.sum(jnp.where(pick, cent_r, 0.0))
        a_i = jnp.sum(jnp.where(pick, cent_i, 0.0))
        a_cnt = jnp.sum(jnp.where(pick, cnt, 0.0))
        # ĥ <- anchor centroid / its own constellation point
        sk_r = jnp.sum(jnp.where(pick, pr, 0.0))
        sk_i = jnp.sum(jnp.where(pick, pi, 0.0))
        sk_norm = sk_r * sk_r + sk_i * sk_i
        new_r = (a_r * sk_r + a_i * sk_i) / sk_norm
        new_i = (a_i * sk_r - a_r * sk_i) / sk_norm
        keep = a_cnt > 0  # empty anchor keeps the previous gain
        return jnp.where(keep, new_r, h_r), jnp.where(keep, new_i, h_i)

    if early_exit:
        def cond(st):
            i, _, _, fixed = st
            return jnp.logical_and(i < iters, fixed == 0)

        def body(st):
            i, h_r, h_i, _ = st
            n_r, n_i = update(h_r, h_i)
            same = jnp.logical_and(n_r == h_r, n_i == h_i)
            return i + 1, n_r, n_i, same.astype(jnp.int32)

        _, h_r, h_i, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), h_r0, h_i0, jnp.int32(0))
        )
    else:
        h_r, h_i = jax.lax.fori_loop(
            0, iters, lambda _, h: update(*h), (h_r0, h_i0)
        )
    hr_ref[0] = h_r
    hi_ref[0] = h_i


def make_blind_estimator_pallas(tables, iters: int = 20, anchor: str = "max",
                                *, early_exit: bool = True,
                                interpret: bool = False):
    """Drop-in for detect.kmeans.make_blind_estimator, as one GPU kernel.

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on
    a host without a GPU); the chain never sets it.
    """
    if anchor not in ("max", "first"):
        raise ValueError(f"anchor must be 'max' or 'first', got {anchor!r}")
    pts_r = np.asarray(tables.points_re, np.float32)
    pts_i = np.asarray(tables.points_im, np.float32)
    m_points = pts_r.shape[0]
    # init anchor as detect/kmeans.py computes it, in f32
    mstar = int(np.argmax(pts_r * pts_r + pts_i * pts_i))
    j = 0 if anchor == "first" else mstar
    init_pt = (float(pts_r[j]), float(pts_i[j]),
               float(pts_r[j] * pts_r[j] + pts_i[j] * pts_i[j]))

    def estimate(yr: jnp.ndarray, yi: jnp.ndarray):
        b, nsym = yr.shape
        chunk, m_pad = chunk_layout(nsym, m_points)
        pr = jnp.asarray(np.pad(pts_r, (0, m_pad - m_points)))
        pi = jnp.asarray(np.pad(pts_i, (0, m_pad - m_points)))
        kern = functools.partial(
            _kmeans_kernel, nsym=nsym, chunk=chunk, m_points=m_points,
            iters=iters, anchor=anchor, init_pt=init_pt, early_exit=early_exit,
        )
        row = pl.BlockSpec((None, nsym), lambda i: (i, 0))
        const = pl.BlockSpec((m_pad,), lambda i: (0,))
        gain = pl.BlockSpec((1,), lambda i: (i,))
        out = jax.ShapeDtypeStruct((b,), jnp.float32)
        h_r, h_i = pl.pallas_call(
            kern,
            out_shape=(out, out),
            grid=(b,),
            in_specs=[row, row, const, const],
            out_specs=(gain, gain),
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
            interpret=interpret,
            name="kmeans_blind",
        )(yr.astype(jnp.float32), yi.astype(jnp.float32), pr, pi)
        # 4 candidates hhat*e^{jk pi/2} = hhat*{1, j, -1, -j}
        # (simulator.cc:146-148)
        h4_r = jnp.stack([h_r, -h_i, -h_r, h_i], axis=1)
        h4_i = jnp.stack([h_i, h_r, -h_i, -h_r], axis=1)
        return h4_r, h4_i

    return estimate
