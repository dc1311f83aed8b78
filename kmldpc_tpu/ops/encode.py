"""Batched systematic LDPC encoder.

The reference encodes one codeword at a time with XOR dot-products against
the dense systematized matrix (``binaryldpccodec.cc:144-162``, 5G variant
``binary5gldpccodec.cc:86-109``).  Here the whole batch's parity bits are one
f32 matmul followed by mod-2: bit counts are at most ``code_dim``
(< 2^24), so float accumulation is exact.

Conventions (identical to the reference, in the permuted column domain):
  classic: cc = [parity | info]
  5G:      cc_full = [info | parity]; the transmitted word is cc_full[2Z:]
           (puncturing of the first two lifting blocks).

``ldpc.active = false`` means "no encoding": the all-zero codeword is
transmitted and the info word forced to zero (binaryldpccodec.cc:156-161).
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
import numpy as np

from ..code.ldpc import LDPCCode


def encoder_table(code: LDPCCode) -> jnp.ndarray:
    """The [K, chk] f32 generator slab — passed to ``encode`` as a runtime
    argument.  Baking it into the traced program as a constant would bloat
    the serialized program by megabytes (PEG2304: 1152x1152 f32) that every
    compile has to carry."""
    return jnp.asarray(code.parity_gen.T.astype(np.float32))


def make_encoder(
    code: LDPCCode, active: bool = True
) -> Callable[[jnp.ndarray, jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray]]:
    """Returns ``encode(uu, gen_t) -> (cc_full, cc_tx)``.

    uu: [B, K] int8; gen_t from :func:`encoder_table`.
    cc_full: [B, num_col] int8 (pre-puncture codeword).
    cc_tx: [B, tx_len] int8 (what enters the mapper).
    """
    punct = code.punct
    is_5g = code.is_5g

    def encode(uu: jnp.ndarray, gen_t: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        if not active:
            b = uu.shape[0]
            cc_full = jnp.zeros((b, code.num_col), dtype=jnp.int8)
            return cc_full, cc_full[:, punct:]
        # Default precision on purpose: both operands are 0/1, which TF32
        # holds exactly, and the products accumulate in f32.
        counts = jnp.dot(
            uu.astype(jnp.float32), gen_t, preferred_element_type=jnp.float32
        )
        parity = jnp.mod(counts, 2.0).astype(jnp.int8)
        if is_5g:
            cc_full = jnp.concatenate([uu, parity], axis=1)
        else:
            cc_full = jnp.concatenate([parity, uu], axis=1)
        return cc_full, cc_full[:, punct:]

    return encode
