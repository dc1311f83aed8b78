"""NumPy float64 oracles replicating the reference algorithms' semantics.

These are *test fixtures*: direct implementations of the probability-domain
equations of ``binaryldpccodec.cc:164-278`` (flooding sum-product with
per-message normalization, clip of c2v into [1e-12, 1-1e-12], VN -> hard ->
syndrome -> break -> CN order) and of the demapper chain
(``modemlinearsystem.cc:51-90`` + ``modem.cc:23-79``), used to validate the
f32 LLR-domain implementations.
"""

from __future__ import annotations

import numpy as np

SMALLEST_PROB = 1e-12


def bp_decode_prob(code, m2v_cols: np.ndarray, iter_count: int):
    """Single-codeword prob-domain flooding BP.

    m2v_cols: [num_col] P(bit=0) per graph column (punctured cols = 0.5).
    Returns (cc_hat, converged, iters, soft_syndrome).
    """
    e = code.num_edges
    edge_col = code.edge_col
    edge_row = code.edge_row
    rows = [np.nonzero(edge_row == r)[0] for r in range(code.num_row)]
    cols = [np.nonzero(edge_col == c)[0] for c in range(code.num_col)]

    c2v = np.full(e, 0.5)
    cc_hat = np.zeros(code.num_col, dtype=np.int64)
    ss = np.ones(code.num_row)
    converged = False
    iters = 0
    for _ in range(iter_count):
        iters += 1
        v2c = np.zeros(e)
        # VN update + posterior hard decision
        for c in range(code.num_col):
            es = cols[c]
            p0 = m2v_cols[c] * np.prod(c2v[es])
            p1 = (1 - m2v_cols[c]) * np.prod(1 - c2v[es])
            cc_hat[c] = 0 if p0 > p1 else 1
            for ei in es:
                q0 = m2v_cols[c] * np.prod(c2v[es[es != ei]])
                q1 = (1 - m2v_cols[c]) * np.prod(1 - c2v[es[es != ei]])
                v2c[ei] = q0 / (q0 + q1)
        # syndrome
        ok = True
        for r in range(code.num_row):
            if np.bitwise_xor.reduce(cc_hat[edge_col[rows[r]]]) != 0:
                ok = False
                break
        if ok:
            converged = True
            break
        # CN update (XOR convolution == tanh rule) + soft syndrome
        for r in range(code.num_row):
            es = rows[r]
            t = 2 * v2c[es] - 1  # tanh of the LLR/2 == p0 - p1
            for ei_pos, ei in enumerate(es):
                prod = np.prod(np.delete(t, ei_pos))
                p0 = (1 + prod) / 2
                p0 = min(max(p0, SMALLEST_PROB), 1 - SMALLEST_PROB)
                c2v[ei] = p0
            ss[r] = (1 + np.prod(t)) / 2
    return cc_hat, converged, iters, ss


def demap_oracle(y: complex, h: complex, var: float, points: np.ndarray, bits: np.ndarray):
    """Brute-force Bayes bit posteriors for one received symbol.

    Replicates SoftAWGNDemodulation (max-normalized exp, clip) + DeMapping
    with uniform bit priors.  Returns P(bit_j = 0) for each of the m bits.
    """
    d2 = np.abs(y - h * points) ** 2 / var
    logits = -(d2 - d2.min())
    p = np.exp(logits)
    p /= p.sum()
    p = np.clip(p, SMALLEST_PROB, 1 - SMALLEST_PROB)
    m = bits.shape[1]
    out = np.zeros(m)
    for j in range(m):
        p0 = p[bits[:, j] == 0].sum()
        p1 = p[bits[:, j] == 1].sum()
        out[j] = p0 / (p0 + p1)
    return np.clip(out, SMALLEST_PROB, 1 - SMALLEST_PROB)


def demap_prior_oracle(
    y: complex,
    h: complex,
    var: float,
    points: np.ndarray,
    bits: np.ndarray,
    prior_p0: np.ndarray,
):
    """Brute-force Bayes prior-in / extrinsic-out demap for one symbol.

    Replicates the full Modem::DeMapping (modem.cc:23-79): symbol prior =
    product of bit priors (:34-45), posterior = prior x likelihood
    normalized (:47-57), marginalize and divide the prior back out
    (:59-73), clip.  float64 throughout.
    """
    prior_p0 = np.clip(prior_p0, SMALLEST_PROB, 1 - SMALLEST_PROB)
    d2 = np.abs(y - h * points) ** 2 / var
    logits = -(d2 - d2.min())
    lik = np.exp(logits)
    lik /= lik.sum()
    lik = np.clip(lik, SMALLEST_PROB, 1 - SMALLEST_PROB)
    m = bits.shape[1]
    sym_prior = np.ones(points.shape[0])
    for j in range(m):
        sym_prior *= np.where(bits[:, j] == 0, prior_p0[j], 1 - prior_p0[j])
    post = sym_prior * lik
    post /= post.sum()
    out = np.zeros(m)
    for j in range(m):
        e0 = post[bits[:, j] == 0].sum() / prior_p0[j]
        e1 = post[bits[:, j] == 1].sum() / (1 - prior_p0[j])
        out[j] = e0 / (e0 + e1)
    return np.clip(out, SMALLEST_PROB, 1 - SMALLEST_PROB)


def demap_llr_batch(y: np.ndarray, h: np.ndarray, var: float,
                    points: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """:func:`demap_oracle` over a whole batch, as clipped channel LLRs.

    y: [B, Nsym] complex, h: [B] complex.  Returns [B, Nsym*m] float64
    ``log(P0/P1)`` of the uniform-prior demap, clipped to +-LLR_CLIP like
    the reference's probabilities are clipped to [1e-12, 1-1e-12].
    """
    d2 = np.abs(y[:, :, None] - h[:, None, None] * points[None, None, :]) ** 2 / var
    p = np.exp(-(d2 - d2.min(axis=-1, keepdims=True)))
    p /= p.sum(axis=-1, keepdims=True)
    p = np.clip(p, SMALLEST_PROB, 1 - SMALLEST_PROB)
    bit0 = (bits == 0).astype(np.float64)  # [M, m]
    llr = np.log(p @ bit0) - np.log(p @ (1.0 - bit0))
    clip = np.log((1 - SMALLEST_PROB) / SMALLEST_PROB)
    return np.clip(llr, -clip, clip).reshape(y.shape[0], -1)
