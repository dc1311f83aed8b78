"""Constellation mapping and soft demapping, batched.

Mapping mirrors ``Modem::Mapping`` (modem.cc:11-20): each group of ``m`` bits
is packed MSB-first into a symbol index, then looked up in the (unit-energy)
constellation table.

Demapping mirrors the two-stage reference pipeline:

1. ``ModemLinearSystem::SoftAWGNDemodulation`` (modemlinearsystem.cc:51-77):
   per received symbol y, symbol likelihoods
   ``P(s_k | y) ∝ exp(-|y - h s_k|^2 / var)`` (max-normalized softmax),
   clipped into [1e-12, 1-1e-12].
2. ``Modem::DeMapping`` (modem.cc:23-79): combine with bit priors (always
   uniform 0.5 in the reference pipeline — kmcodec.cc:99-101), marginalize to
   extrinsic bit probabilities P(bit=0), divide out the prior, clip.

We fold the two stages into one jitted function over the whole batch; the
bit marginalization is a [B*Nsym, M] @ [M, m] contraction at HIGHEST
precision (a GPU may otherwise run it in TF32, ~1e-3 relative).  The output
is returned both as P(bit=0) (reference's ``bit_l_out_``) and as the LLR
``log(P0/P1)`` that feeds the LLR-domain BP decoder; thanks to the shared
clipping constant the LLR is bounded by ±LLR_CLIP exactly as the reference's
probabilities are bounded by [1e-12, 1-1e-12].

Complex numbers are carried as separate (real, imag) float32 planes;
complex dtypes appear only in host-side NumPy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..io.constellation import Constellation


@dataclasses.dataclass(frozen=True)
class ModemTables:
    """Device-resident constellation tables."""

    bits_per_symbol: int
    points_re: jnp.ndarray  # [M] f32
    points_im: jnp.ndarray  # [M] f32
    bit0_mask: jnp.ndarray  # [M, m] f32 — 1 where bit j of symbol k is 0
    pack_weights: jnp.ndarray  # [m] f32 — MSB-first powers of two

    @property
    def num_points(self) -> int:
        return int(self.points_re.shape[0])

    @staticmethod
    def from_constellation(c: Constellation) -> "ModemTables":
        m = c.bits_per_symbol
        return ModemTables(
            bits_per_symbol=m,
            points_re=jnp.asarray(c.points.real.astype(np.float32)),
            points_im=jnp.asarray(c.points.imag.astype(np.float32)),
            bit0_mask=jnp.asarray(c.bit0_mask().astype(np.float32)),
            pack_weights=jnp.asarray(
                (2.0 ** np.arange(m - 1, -1, -1)).astype(np.float32)
            ),
        )


def make_mapper(tables: ModemTables) -> Callable[[jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray]]:
    """Returns ``map_bits(cc_tx) -> (xr, xi)``; cc_tx: [B, n_tx] int bits."""
    m = tables.bits_per_symbol

    def map_bits(cc_tx: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        b, n = cc_tx.shape
        groups = cc_tx.reshape(b, n // m, m).astype(jnp.float32)
        # Default precision on purpose: 0/1 bits times powers of two up to
        # 2^(m-1) are exact in TF32, and the sums accumulate in f32.
        idx = jnp.dot(
            groups, tables.pack_weights, preferred_element_type=jnp.float32
        ).astype(jnp.int32)
        return tables.points_re[idx], tables.points_im[idx]

    return map_bits


def make_soft_demapper(
    tables: ModemTables,
) -> Callable[..., tuple[jnp.ndarray, jnp.ndarray]]:
    """Returns ``demap(yr, yi, hr, hi, var) -> (bit_p0, chan_llr)``.

    yr/yi: [B, Nsym]; hr/hi: [B] (one channel gain per codeword, the
    reference's single-partition case — simulator.cc:127-130); var: scalar
    noise variance 10^(-SNR/10).
    Outputs are [B, Nsym*m]: P(bit=0) clipped to [1e-12, 1-1e-12] and the
    matching LLR.
    """
    m = tables.bits_per_symbol
    clip_lo = constants.SMALLEST_PROB
    clip_hi = 1.0 - constants.SMALLEST_PROB

    def demap(yr, yi, hr, hi, var):
        b, nsym = yr.shape
        # h*s_k for each codeword: [B, 1, M]
        hs_re = hr[:, None] * tables.points_re[None, :] - hi[:, None] * tables.points_im[None, :]
        hs_im = hr[:, None] * tables.points_im[None, :] + hi[:, None] * tables.points_re[None, :]
        dre = yr[:, :, None] - hs_re[:, None, :]
        dim = yi[:, :, None] - hs_im[:, None, :]
        logits = -(dre * dre + dim * dim) / var  # [B, Nsym, M]
        logits = logits - jnp.max(logits, axis=-1, keepdims=True)
        p = jnp.exp(logits)
        p = p / jnp.sum(p, axis=-1, keepdims=True)
        # reference clips symbol probabilities before marginalizing
        # (modem.cc:26-27 via ProbClip on symRin).
        p = jnp.clip(p, clip_lo, clip_hi)
        # bit marginalization: [B, Nsym, M] @ [M, m]
        hi = jax.lax.Precision.HIGHEST
        p0 = jnp.einsum("bsm,mj->bsj", p, tables.bit0_mask, precision=hi)
        p1 = jnp.einsum("bsm,mj->bsj", p, 1.0 - tables.bit0_mask, precision=hi)
        bit_p0 = p0 / (p0 + p1)
        bit_p0 = jnp.clip(bit_p0, clip_lo, clip_hi).reshape(b, nsym * m)
        # LLR from the unnormalized marginals: 1 - 1e-12 is not
        # representable in f32, so log1p(-clipped_p0) would hit exactly
        # -inf for confident bits (the f64 reference gets finite +-27.63
        # there).  log(p0) - log(p1) with the explicit clip reproduces the
        # reference's clipped value with no infinities.
        chan_llr = jnp.clip(
            (jnp.log(p0) - jnp.log(p1)).reshape(b, nsym * m),
            -constants.LLR_CLIP,
            constants.LLR_CLIP,
        )
        return bit_p0, chan_llr

    return demap


def make_prior_demapper(
    tables: ModemTables,
) -> Callable[..., tuple[jnp.ndarray, jnp.ndarray]]:
    """Prior-in / extrinsic-out soft demapper — the full ``Modem::DeMapping``
    capability (modem.cc:23-79), for iterative demodulation loops.

    Returns ``demap(yr, yi, hr, hi, var, bit_p0_in) -> (bit_p0_out, ext_llr)``
    where ``bit_p0_in`` is the extrinsic bit prior P(bit=0) from the decoder,
    shaped [B, Nsym*m].  Semantics per the reference:

    * symbol prior = product of the symbol's bit priors (modem.cc:34-45),
    * posterior ∝ prior × channel likelihood, normalized (modem.cc:47-57),
    * marginalize to bit posteriors, divide the prior back out
      (modem.cc:59-73 — the extrinsic output), clip.

    With uniform priors (0.5 everywhere) this is exactly
    :func:`make_soft_demapper` — the constant prior product cancels in the
    normalization and the ÷0.5 cancels in the ratio (pinned by test).  The
    main reference pipeline only ever feeds uniform priors (kmcodec.cc:99-101),
    so the simulation chain keeps the fused uniform demapper; this entry
    point restores the API capability for iterative-demapping experiments.

    f32 note: the reference's ProbClip bounds bitLin into [1e-12, 1-1e-12]
    in f64, making both the prior and its complement ≥ 1e-12.  1-1e-12 is
    not representable in f32, so the prior and its complement are clipped
    *separately* — same effective bounds, no infinities.
    """
    m = tables.bits_per_symbol
    clip_lo = constants.SMALLEST_PROB
    clip_hi = 1.0 - constants.SMALLEST_PROB

    def demap(yr, yi, hr, hi, var, bit_p0_in):
        b, nsym = yr.shape
        hs_re = hr[:, None] * tables.points_re[None, :] - hi[:, None] * tables.points_im[None, :]
        hs_im = hr[:, None] * tables.points_im[None, :] + hi[:, None] * tables.points_re[None, :]
        dre = yr[:, :, None] - hs_re[:, None, :]
        dim = yi[:, :, None] - hs_im[:, None, :]
        logits = -(dre * dre + dim * dim) / var  # [B, Nsym, M]
        logits = logits - jnp.max(logits, axis=-1, keepdims=True)
        p = jnp.exp(logits)
        p = p / jnp.sum(p, axis=-1, keepdims=True)
        p = jnp.clip(p, clip_lo, clip_hi)  # symRin after ProbClip

        pin = bit_p0_in.reshape(b, nsym, m)
        pin0 = jnp.clip(pin, clip_lo, clip_hi)
        pin1 = jnp.clip(1.0 - pin, clip_lo, clip_hi)
        # symbol log-prior: [B, Nsym, m] @ [m, M] per bit value
        hi = jax.lax.Precision.HIGHEST
        log_prior = jnp.einsum(
            "bsj,mj->bsm", jnp.log(pin0), tables.bit0_mask, precision=hi
        ) + jnp.einsum(
            "bsj,mj->bsm", jnp.log(pin1), 1.0 - tables.bit0_mask, precision=hi
        )
        post = p * jnp.exp(log_prior - jnp.max(log_prior, axis=-1, keepdims=True))
        post = post / jnp.sum(post, axis=-1, keepdims=True)
        p0 = jnp.einsum("bsm,mj->bsj", post, tables.bit0_mask, precision=hi)
        p1 = jnp.einsum("bsm,mj->bsj", post, 1.0 - tables.bit0_mask, precision=hi)
        e0 = p0 / pin0  # extrinsic: divide the prior back out
        e1 = p1 / pin1
        bit_p0_out = jnp.clip(e0 / (e0 + e1), clip_lo, clip_hi).reshape(b, nsym * m)
        ext_llr = jnp.clip(
            (jnp.log(e0) - jnp.log(e1)).reshape(b, nsym * m),
            -constants.LLR_CLIP,
            constants.LLR_CLIP,
        )
        return bit_p0_out, ext_llr

    return demap


def make_partition_demapper(tables: ModemTables, num_parts: int):
    """Soft demapper for per-segment channel gains (``thetaList`` plumbing).

    Mirrors ``ModemLinearSystem::SoftDemodulation`` over a theta list
    (modemlinearsystem.cc:80-90): symbol j in segment p is demapped against
    h_p.  hr/hi: [B, num_parts].  This is the *intended* semantics of the
    reference's partition API (its own >1-partition channel path is broken —
    see ops/channel.py); with num_parts == 1 it reduces exactly to
    :func:`make_soft_demapper`.
    """
    demap = make_soft_demapper(tables)
    m = tables.bits_per_symbol

    def demap_parts(yr, yi, hr, hi, var):
        b, nsym = yr.shape
        if nsym % num_parts != 0:
            raise ValueError(f"{nsym} symbols not divisible into {num_parts} parts")
        seg = nsym // num_parts
        # fold segments into the batch: [B, P, seg] -> [B*P, seg]
        yr_f = yr.reshape(b * num_parts, seg)
        yi_f = yi.reshape(b * num_parts, seg)
        hr_f = hr.reshape(b * num_parts)
        hi_f = hi.reshape(b * num_parts)
        p0, llr = demap(yr_f, yi_f, hr_f, hi_f, var)
        return p0.reshape(b, nsym * m), llr.reshape(b, nsym * m)

    return demap_parts
