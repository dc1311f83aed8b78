"""Blind channel estimation: the "hacked" k-means over received symbols.

Reference: ``KMeans::Run`` (kmeans.cc:14-84).  The clusters are never free —
after every centroid update they are snapped back to the constellation
geometry scaled by a single complex gain ĥ ("Form to the constellation
schema", kmeans.cc:64-74), so the whole loop is really a fixed-point
iteration on one complex parameter:

    init:  ĥ = y[argmax |y|] / s_0                       (kmeans.cc:17-27)
    iter:  assign each y_j to nearest cluster s_k·ĥ
           centroids c_k = mean of assigned points
           ĥ ← c_anchor / s_0                            (re-projection)

Reference quirks NOT replicated (SURVEY.md section 7 "known quirks"):

* ``idxCount``/``idxSum`` are ``.clear()``-ed then indexed past their size
  each iteration (kmeans.cc:33-44) — capacity-reliant UB whose de-facto
  effect is accumulating assignment sums across iterations.  We implement
  the intended semantics: accumulators zeroed per iteration.
* The re-anchoring max-|cluster| search iterates over an emptied vector
  (kmeans.cc:65-68), so ``maxIndex`` collapses to 0 and the de-facto anchor
  is always cluster 0.  We default to the *intended* max-|centroid| anchor
  (``anchor="max"``) and provide ``anchor="first"`` for bit-level mimicry of
  the de-facto behavior.
* The reference divides the anchor centroid by ``constellations_[0]``
  UNCONDITIONALLY (kmeans.cc:25,73) — scale-correct only when s_0 is
  itself a maximum-modulus point.  That holds for the corner-first tables
  (QPSK/Gray-16QAM/64QAM: s_0 is a corner, and any max-modulus anchor is a
  π/2 rotation of it, absorbed by the 4-candidate resolution) but BREAKS
  for the phi1/phi2 16QAM tables whose row 0 is an inner point: ĥ
  converges 3× too large and blind detection fails outright (verified:
  the C++ code has the same /s_0 in both init and re-projection).  In
  "max" mode we therefore divide the anchored centroid by its OWN
  constellation point s_{k*} (and the init outlier by the max-modulus
  point) — identical behavior up to an exact π/2 rotation on corner-first
  tables, and correct for any table order.  "first" keeps the verbatim
  de-facto /s_0 behavior.
* Convergence break on exact cluster equality (kmeans.cc:47-54) is dropped:
  we always run the fixed ``iters`` budget (converged batches are
  idempotent), which keeps the batched program shape static.

Empty-anchor guard: if the anchor cluster has no members the reference
produces NaN (0/0); we keep the previous ĥ instead (divergence documented).

The per-iteration assignment + centroid update is one [B·Nsym, M] distance
computation and two one-hot contractions, batched over the whole
Monte-Carlo chunk.  This is the plain version XLA compiles; on the GPU the
chain runs the fused kernel of detect/kmeans_pallas.py instead.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..ops.modem import ModemTables


def make_blind_estimator(
    tables: ModemTables, iters: int = 20, anchor: str = "max"
) -> Callable[[jnp.ndarray, jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray]]:
    """Returns ``estimate(yr, yi) -> (h4_r, h4_i)``.

    yr/yi: [B, Nsym] received symbols.  Output: the 4 phase-ambiguity
    candidates ĥ·e^{jkπ/2}, k = 0..3, as [B, 4] arrays
    (simulator.cc:145-148).
    """
    if anchor not in ("max", "first"):
        raise ValueError(f"anchor must be 'max' or 'first', got {anchor!r}")
    sr = tables.points_re  # [M]
    si = tables.points_im
    m = sr.shape[0]
    s0_r, s0_i = sr[0], si[0]
    s0_norm = s0_r * s0_r + s0_i * s0_i
    # init anchor: the max-modulus constellation point (= s_0 on the
    # corner-first tables; the module docstring explains why not plain s_0)
    mstar = int(jnp.argmax(sr**2 + si**2))
    init_idx = 0 if anchor == "first" else mstar
    sI_r, sI_i = sr[init_idx], si[init_idx]
    sI_norm = sI_r * sI_r + sI_i * sI_i

    def estimate(yr: jnp.ndarray, yi: jnp.ndarray):
        # --- init: point farthest from the origin, anchored to the
        # max-modulus constellation point ---
        mag2 = yr * yr + yi * yi
        jstar = jnp.argmax(mag2, axis=1)  # [B]
        ymax_r = jnp.take_along_axis(yr, jstar[:, None], axis=1)[:, 0]
        ymax_i = jnp.take_along_axis(yi, jstar[:, None], axis=1)[:, 0]
        # ĥ = y_max / s_init (complex division)
        h_r = (ymax_r * sI_r + ymax_i * sI_i) / sI_norm
        h_i = (ymax_i * sI_r - ymax_r * sI_i) / sI_norm

        def body(_, h):
            h_r, h_i = h
            # clusters s_k·ĥ: [B, M]
            cr = h_r[:, None] * sr[None, :] - h_i[:, None] * si[None, :]
            ci = h_r[:, None] * si[None, :] + h_i[:, None] * sr[None, :]
            dre = yr[:, :, None] - cr[:, None, :]
            dim = yi[:, :, None] - ci[:, None, :]
            d2 = dre * dre + dim * dim  # [B, Nsym, M]
            assign = jnp.argmin(d2, axis=-1)  # [B, Nsym]
            onehot = jax.nn.one_hot(assign, m, dtype=yr.dtype)  # [B, Nsym, M]
            counts = jnp.sum(onehot, axis=1)  # [B, M]
            # HIGHEST: a GPU may run a default-precision f32 contraction
            # in TF32 (~1e-3 relative), which would bias the centroids
            hi = jax.lax.Precision.HIGHEST
            sum_r = jnp.einsum("bs,bsm->bm", yr, onehot, precision=hi)
            sum_i = jnp.einsum("bs,bsm->bm", yi, onehot, precision=hi)
            safe = jnp.maximum(counts, 1.0)
            cent_r = sum_r / safe
            cent_i = sum_i / safe
            if anchor == "first":
                k = jnp.zeros(yr.shape[0], dtype=jnp.int32)
                # de-facto reference: cluster 0 / s_0 (kmeans.cc:65-73)
                sk_r = jnp.full_like(cent_r[:, 0], s0_r)
                sk_i = jnp.full_like(cent_i[:, 0], s0_i)
            else:
                cmag = jnp.where(counts > 0, cent_r**2 + cent_i**2, -1.0)
                k = jnp.argmax(cmag, axis=1)
                # intended semantics: the anchored centroid estimates
                # h·s_{k*}, so divide by its OWN constellation point
                sk_r = sr[k]
                sk_i = si[k]
            a_r = jnp.take_along_axis(cent_r, k[:, None], axis=1)[:, 0]
            a_i = jnp.take_along_axis(cent_i, k[:, None], axis=1)[:, 0]
            a_cnt = jnp.take_along_axis(counts, k[:, None], axis=1)[:, 0]
            sk_norm = sk_r * sk_r + sk_i * sk_i
            new_r = (a_r * sk_r + a_i * sk_i) / sk_norm
            new_i = (a_i * sk_r - a_r * sk_i) / sk_norm
            keep = a_cnt > 0
            return jnp.where(keep, new_r, h_r), jnp.where(keep, new_i, h_i)

        # NOTE: the reference's per-block convergence break (kmeans.cc:47-54)
        # has no useful batched analogue: measured at 15 dB, ~2% of blocks
        # oscillate in small limit cycles and never satisfy exact equality,
        # so a batch-wide early-stop never fires and only adds predicate
        # overhead.  Fixed budget, like the reference's worst case.
        h_r, h_i = jax.lax.fori_loop(0, iters, body, (h_r, h_i))

        # 4 candidates ĥ·e^{jkπ/2} = ĥ·{1, j, -1, -j} (simulator.cc:146-148)
        h4_r = jnp.stack([h_r, -h_i, -h_r, h_i], axis=1)
        h4_i = jnp.stack([h_i, h_r, -h_i, -h_r], axis=1)
        return h4_r, h4_i

    return estimate


def add_diagnostics(estimate, tables: ModemTables):
    """Wrap any blind estimator with the reference's inspection surface.

    ``KMeans`` exposes ``clusters`` and ``idx`` after ``Run`` (kmeans.h:19-21)
    for ``DumpToMat`` (kmeans.cc:96-111).  Because the clusters are always
    re-projected to the constellation scaled by the single gain — the final
    state is ``cluster_k = s_k * hhat`` followed by one assignment pass
    (kmeans.cc:76-83) — both are pure functions of the final hhat, so this
    wrapper recovers them from candidate 0 without touching the estimator
    loop (works over the pure-JAX and Pallas implementations alike).

    Returns ``estimate_diag(yr, yi) -> (h4_r, h4_i, cl_r, cl_i, idx)`` with
    ``cl_*``: [B, M] final clusters and ``idx``: [B, Nsym] int32 assignments.
    """
    sr, si = tables.points_re, tables.points_im

    def estimate_diag(yr: jnp.ndarray, yi: jnp.ndarray):
        h4_r, h4_i = estimate(yr, yi)
        h_r, h_i = h4_r[:, 0], h4_i[:, 0]  # candidate 0 = the k-means hhat
        cl_r = h_r[:, None] * sr[None, :] - h_i[:, None] * si[None, :]
        cl_i = h_r[:, None] * si[None, :] + h_i[:, None] * sr[None, :]
        dre = yr[:, :, None] - cl_r[:, None, :]
        dim = yi[:, :, None] - cl_i[:, None, :]
        idx = jnp.argmin(dre * dre + dim * dim, axis=-1).astype(jnp.int32)
        return h4_r, h4_i, cl_r, cl_i, idx

    return estimate_diag
