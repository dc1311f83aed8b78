"""kmldpc_tpu — a batched JAX (XLA + Pallas) link-level simulation framework.

A from-scratch rebuild of the capabilities of the C++ reference simulator
``trganda/kmldpc``: LDPC-coded modulation over a one-tap Rayleigh-fading +
AWGN channel with k-means blind channel estimation, phase-ambiguity
resolution via decoder-derived metrics, soft demapping and iterative
belief-propagation decoding — as batched, jitted array programs that run on
one GPU or are sharded over a device mesh.  (The package name and the
``[tpu]`` config table keep their historical names.)
"""

__version__ = "0.1.0"

from .config import Config, load_config  # noqa: F401
