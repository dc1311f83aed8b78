"""Tests for auxiliary subsystems: record export, partitioned-h plumbing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kmldpc_tpu.io import parse_constellation
from kmldpc_tpu.ops.channel import partitioned_fading_awgn_channel
from kmldpc_tpu.ops.modem import ModemTables, make_partition_demapper, make_soft_demapper
from kmldpc_tpu.utils.records import RecordWriter, dump_kmeans


def test_record_writer_roundtrip(tmp_path):
    w = RecordWriter(str(tmp_path / "rec"))
    w.write_int("n", 7)
    w.write_double("x", 2.5)
    w.write_complex("h", 1 + 2j)
    w.write_vector("v", np.arange(4, dtype=np.complex128) * 1j)
    path = w.close()
    if path.endswith(".mat"):
        from scipy.io import loadmat

        d = loadmat(path)
        assert int(d["n"].squeeze()) == 7
        assert complex(d["h"].squeeze()) == 1 + 2j
        np.testing.assert_allclose(
            d["v"].squeeze(), np.arange(4) * 1j, atol=1e-12
        )
    else:
        d = np.load(path)
        assert int(d["n"]) == 7


def test_dump_kmeans_names(tmp_path):
    path = dump_kmeans(
        str(tmp_path / "km"),
        data=np.zeros(8, complex),
        clusters=np.ones(4, complex),
        idx=np.zeros(8, int),
        constellations=np.ones(4, complex),
        h_hats=np.ones(6, complex),  # only first 4 kept, like the reference
        real_h=0.5 + 0.5j,
    )
    if path.endswith(".mat"):
        from scipy.io import loadmat

        d = loadmat(path)
        for name in ["data", "cluster", "idx", "constellations", "hHats", "realH"]:
            assert name in d
        assert d["hHats"].size == 4
    else:
        assert "hHats" in np.load(path)


def test_partition_channel_and_demap(assets):
    """Two-segment channel: the partition demapper recovers each segment's
    bits with its own gain; a single-h demap on the same data fails."""
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    tables = ModemTables.from_constellation(const)
    rng = np.random.default_rng(0)
    b, nsym, m = 4, 64, 2
    bits = rng.integers(0, 2, size=(b, nsym * m)).astype(np.int8)
    from kmldpc_tpu.ops.modem import make_mapper

    xr, xi = make_mapper(tables)(jnp.asarray(bits))
    yr, yi, hr, hi = partitioned_fading_awgn_channel(
        jax.random.key(5), xr, xi, sigma=1e-3, num_parts=2
    )
    assert hr.shape == (b, 2)
    demap2 = make_partition_demapper(tables, 2)
    _, llr = demap2(yr, yi, hr, hi, np.float32(1e-6))
    decided = (np.asarray(llr) <= 0).astype(np.int8)
    np.testing.assert_array_equal(decided, bits)
    # single-h demap with segment-0's gain misdecodes segment 1 w.h.p.
    demap1 = make_soft_demapper(tables)
    _, llr1 = demap1(yr, yi, hr[:, 0], hi[:, 0], np.float32(1e-6))
    wrong = (np.asarray(llr1) <= 0).astype(np.int8) != bits
    assert wrong[:, nsym // 2 * m :].mean() > 0.2


def test_partition_demap_one_part_equals_plain(assets):
    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    tables = ModemTables.from_constellation(const)
    rng = np.random.default_rng(1)
    yr = jnp.asarray(rng.normal(size=(3, 8)), jnp.float32)
    yi = jnp.asarray(rng.normal(size=(3, 8)), jnp.float32)
    hr = jnp.asarray(rng.normal(size=3), jnp.float32)
    hi = jnp.asarray(rng.normal(size=3), jnp.float32)
    p1, l1 = make_soft_demapper(tables)(yr, yi, hr, hi, np.float32(0.1))
    p2, l2 = make_partition_demapper(tables, 1)(
        yr, yi, hr[:, None], hi[:, None], np.float32(0.1)
    )
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), rtol=1e-6)


def test_partition_indivisible_raises(assets):
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    tables = ModemTables.from_constellation(const)
    with pytest.raises(ValueError):
        make_partition_demapper(tables, 3)(
            jnp.zeros((1, 8)), jnp.zeros((1, 8)),
            jnp.zeros((1, 3)), jnp.zeros((1, 3)), 0.1,
        )


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing is set
    in code (JAX reads the variable itself)."""
    from kmldpc_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_repo_dir(monkeypatch):
    """Without the variable the cache is <repo>/.jax_cache, which git
    ignores — the same path in every process and every run."""
    import pathlib

    from kmldpc_tpu.utils.compile_cache import enable_compile_cache

    repo = pathlib.Path(__file__).resolve().parent.parent
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == str(repo / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(repo / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_chip_smoke_fails_without_gpu(args):
    """Without a GPU chip_smoke.py exits non-zero and prints no ok line."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, str(repo / "chip_smoke.py"), *args],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "JAX finds no GPU" in p.stderr
