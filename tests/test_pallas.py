"""GPU k-means kernel (Triton route): interpret-mode equivalence on the CPU."""

import jax
import numpy as np
import pytest

from kmldpc_tpu.detect.kmeans import make_blind_estimator
from kmldpc_tpu.detect.kmeans_pallas import chunk_layout, make_blind_estimator_pallas
from kmldpc_tpu.io import parse_constellation
from kmldpc_tpu.ops.modem import ModemTables


def _tables(assets, fname):
    return ModemTables.from_constellation(parse_constellation(str(assets / fname)))


@pytest.mark.parametrize("fname,anchor", [
    ("2bits_QPSK.txt", "max"),
    ("4bit_16QAM_Gray.txt", "max"),
    ("6bits_64QAM_Gray.txt", "max"),
    ("4bit_16QAM_Gray.txt", "first"),
])
def test_pallas_kmeans_matches_jax(assets, fname, anchor):
    """The fused kernel must agree with the plain estimator.

    On the CPU the kernel runs in the Pallas interpreter; the compiled
    kernel is checked against the same reference on the GPU by
    tests/test_chip.py and chip_smoke.py.
    """
    tables = _tables(assets, fname)
    yr = jax.random.normal(jax.random.key(0), (16, 288))
    yi = jax.random.normal(jax.random.key(1), (16, 288))
    h4p = make_blind_estimator_pallas(tables, 20, anchor, interpret=True)(yr, yi)
    h4j = make_blind_estimator(tables, 20, anchor)(yr, yi)
    np.testing.assert_allclose(np.asarray(h4j[0]), np.asarray(h4p[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(h4j[1]), np.asarray(h4p[1]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "fname", ["2bits_QPSK.txt", "6bits_64QAM_Gray.txt"]
)
def test_pallas_kmeans_early_exit_bit_identical(assets, fname):
    """Early exit at a fixed point of ĥ must be BIT-identical to the full
    fixed-trip loop: ĥ -> assignment -> ĥ is deterministic, so a repeated
    gain repeats forever — exiting early skips only no-op iterations."""
    tables = _tables(assets, fname)
    yr = jax.random.normal(jax.random.key(5), (16, 288))
    yi = jax.random.normal(jax.random.key(6), (16, 288))
    h_ee = make_blind_estimator_pallas(tables, 20, "max", interpret=True)(yr, yi)
    h_full = make_blind_estimator_pallas(
        tables, 20, "max", early_exit=False, interpret=True
    )(yr, yi)
    np.testing.assert_array_equal(np.asarray(h_ee[0]), np.asarray(h_full[0]))
    np.testing.assert_array_equal(np.asarray(h_ee[1]), np.asarray(h_full[1]))


def test_chunk_layout_and_grid():
    """Column chunks and the padded constellation are powers of two, a
    [chunk, M] step stays at 4096 elements, a chunk never exceeds the padded
    row, and the grid has one program per row of any batch."""
    assert chunk_layout(1152, 4) == (1024, 4)  # QPSK: 2 chunks, 2nd masked
    assert chunk_layout(576, 16) == (256, 16)
    assert chunk_layout(1344, 64) == (64, 64)  # PEG8064 + 64QAM: 21 chunks
    assert chunk_layout(5, 4) == (8, 4)  # short row: one masked chunk
    assert chunk_layout(288, 12) == (256, 16)  # M padded, pad points masked
    tables = ModemTables(
        bits_per_symbol=2,
        points_re=np.asarray([1.0, -1.0, -1.0, 1.0], np.float32) / np.sqrt(2),
        points_im=np.asarray([1.0, 1.0, -1.0, -1.0], np.float32) / np.sqrt(2),
        bit0_mask=np.zeros((4, 2), np.float32),
        pack_weights=np.asarray([2.0, 1.0], np.float32),
    )
    est = make_blind_estimator_pallas(tables)
    y = jax.ShapeDtypeStruct((7, 300), np.float32)
    jaxpr = jax.make_jaxpr(est)(y, y)
    (call,) = [e for e in jaxpr.eqns if e.primitive.name == "pallas_call"]
    assert call.params["grid_mapping"].grid == (7,)
    assert call.params["backend"] == "triton"


@pytest.mark.parametrize("b", [100, 12, 7])
def test_pallas_kmeans_odd_batch(assets, b):
    """Every row of a batch of any size gets its own program and its own
    gain; every row must agree with the plain estimator."""
    tables = _tables(assets, "4bit_16QAM_Gray.txt")
    yr = jax.random.normal(jax.random.key(2), (b, 288))
    yi = jax.random.normal(jax.random.key(3), (b, 288))
    h4p = make_blind_estimator_pallas(tables, interpret=True)(yr, yi)
    h4j = make_blind_estimator(tables)(yr, yi)
    np.testing.assert_allclose(np.asarray(h4j[0]), np.asarray(h4p[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(h4j[1]), np.asarray(h4p[1]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl,platform,expect", [
    ("auto", "gpu", "pallas"),
    ("auto", "cpu", "jax"),
    ("jax", "gpu", "jax"),
    ("pallas", "gpu", "pallas"),
    ("auto", "tpu", None),  # no implementation named for the platform
    ("pallas", "cpu", None),  # the kernel never runs off the GPU
    ("mosaic", "gpu", None),  # unknown value
])
def test_kmeans_impl_names_the_platform(impl, platform, expect):
    from kmldpc_tpu.sim.chain import kmeans_impl_for

    if expect is None:
        with pytest.raises(ValueError):
            kmeans_impl_for(impl, platform)
    else:
        assert kmeans_impl_for(impl, platform) == expect


def test_chain_refuses_kernel_on_cpu(assets):
    """Building a chain that asks for the kernel on the CPU raises at build
    time (no quiet interpret mode); "auto" builds the plain estimator."""
    from kmldpc_tpu.code import load_code
    from kmldpc_tpu.sim.chain import ChainSpec, build_frontend_fn, target_platform

    assert target_platform() == "cpu"
    spec = ChainSpec(
        code=load_code(str(assets / "PEG2304regular0.5.txt")),
        constellation=parse_constellation(str(assets / "2bits_QPSK.txt")),
        known_h=False, fading=True, metric_type=False, metric_iter=5,
        max_iter=5, encoder_active=True, histogram=False, kmeans_impl="pallas",
    )
    with pytest.raises(ValueError, match="GPU kernel"):
        build_frontend_fn(spec, 4)
    with jax.default_device(jax.devices("cpu")[0]):
        assert target_platform() == "cpu"
