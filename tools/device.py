"""The device a measurement runs on: a GPU, named with its card.

Shared by bench.py, tools/microbench.py and chip_smoke.py.  A measurement
that finds no GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess


def card() -> str:
    """``nvidia-smi``'s name and power limit of each card, read by a child
    process that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def require_gpu(count: int = 1):
    """JAX's first device, which must be a GPU, with at least ``count``
    devices visible; exits with a message otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"JAX finds no GPU (first device: {devs[0].platform})")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX finds {len(devs)}")
    return devs[0]


def describe(dev) -> str:
    """One line naming the device as JAX reports it and the card."""
    import jax

    return (f"platform={dev.platform} kind={dev.device_kind} "
            f"count={len(jax.devices())}; card: {card()}")
