"""Configuration system: dataclasses mirroring the reference's ``config.toml``.

The reference threads a single parsed TOML value through every constructor
(``/root/reference/kmldpc/kmldpc.cpp:29-40``); its schema has six tables —
``[range] [decoder] [xcodec] [histogram] [ldpc] [modem]``
(``/root/reference/config/config.toml:1-33``).  We parse the same schema with
the standard-library ``tomllib`` into typed dataclasses and add a handful of
framework-only knobs under ``[tpu]`` (batch size, dtype, mesh shape; the
table keeps its historical name), all optional with defaults, so every
reference config file loads unchanged.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Any


class ConfigError(ValueError):
    """Malformed configuration (unknown table/key, bad value).

    The reference fails loudly on schema mismatches (``toml::find`` throws
    on a missing key, kmldpc.cpp:29-40); we match that spirit in the other
    direction too — a typo'd knob must not silently revert to its default.
    """


@dataclasses.dataclass(frozen=True)
class RangeConfig:
    """SNR sweep + stopping rules (`[range]`, simulator.cc:7-13)."""

    minimum_snr: float = 15.0
    maximum_snr: float = 15.0
    step_snr: float = 5.0
    maximum_error_number: int = 1
    maximum_block_number: int = 1
    # In the reference this is the per-task chunk size of the inner thread
    # pool (simulator.cc:90-100).  Here it is the default for the device
    # batch size when [tpu].batch is not given (see TpuConfig.batch).
    thread_block_number: int = 1


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """`[decoder]` — known-h (coherent) vs. blind detection (simulator.cc:14)."""

    true_h_arg: bool = False


@dataclasses.dataclass(frozen=True)
class XCodecConfig:
    """`[xcodec]` — codec family + ambiguity-metric mode (kmcodec.cc:22-25)."""

    ldpc_5g: bool = False
    # False => hard metric (count failed parity checks),
    # True  => soft metric (sum of log soft-syndromes).
    metric_type: bool = False
    metric_iter: int = 5


@dataclasses.dataclass(frozen=True)
class HistogramConfig:
    """`[histogram]` — dump rotated 4-candidate metric vectors per block."""

    enable: bool = False


@dataclasses.dataclass(frozen=True)
class LdpcConfig:
    """`[ldpc]` (binaryldpccodec.cc:70-73)."""

    max_iter: int = 50
    active: bool = True
    matrix_file: str = "PEG2304regular0.5.txt"


@dataclasses.dataclass(frozen=True)
class ModemConfig:
    """`[modem]` (modem.cc:6-8)."""

    modem_file: str = "2bits_QPSK.txt"


@dataclasses.dataclass(frozen=True)
class TpuConfig:
    """Framework-only knobs, the ``[tpu]`` table (no reference analogue)."""

    # Monte-Carlo chunk size per device launch (codewords per chunk).
    # 0 = auto: use [range].thread_block_number when it is meaningfully set
    # (> 1 — the reference's per-task chunk size plays the same role,
    # simulator.cc:90-100), else 1024.
    batch: int = 0
    # Compute dtype for the BP decoder / demapper ("float32" | "bfloat16").
    dtype: str = "float32"
    # Decoder schedule: "flooding" (reference parity) | "layered-minsum"
    # (QC fast path for 5G codes) | "flooding-minsum" (min-sum CN rule on
    # the flooding schedule — the transcendental-free option for non-QC
    # codes such as PEG8064).
    schedule: str = "flooding"
    # Normalization factor for min-sum (standard 5G choice).
    minsum_alpha: float = 0.75
    # Ambiguity-metric decode schedule: "flooding" (reference parity) or
    # "match" (use the final schedule's decoder for metric decodes too —
    # with layered-minsum the QC fast path makes blind 5G much faster).
    metric_schedule: str = "flooding"
    # Blind k-means implementation: "auto" (the fused kernel on a GPU, the
    # plain estimator on the CPU; sim/chain.py kmeans_impl_for) | "jax"
    # (plain) | "pallas" (the GPU kernel; raises on any other platform).
    kmeans_impl: str = "auto"
    # Opt-in: skip the two complement metric candidates when they exactly
    # tie the computed pair (complement-closed constellation +
    # even-degree rows: the shipped QPSK table + PEG codes — detect/metric.py
    # complement_closed).  Halves the blind metric stage; the selected h
    # is unchanged (first-minimum tie-breaking never picks the skipped
    # pair).  Statistically, not bitwise, identical.
    metric_prune: bool = False
    # Exact two-phase decode tuning (bit-identical results for any value):
    # phase-1 iterations on the full batch, phase-2 tile width (0 = batch/8).
    phase1_iters: int = 3
    tile: int = 0
    # Sub-chunks folded into one device launch (lax.scan), so each launch's
    # fixed host cost is paid once per chunks_per_launch chunks; the
    # stopping-rule granularity becomes chunks_per_launch * batch blocks.
    chunks_per_launch: int = 8
    # Data-parallel axis size; 0 = use all visible devices.
    data_parallel: int = 0
    # Model-parallel axis size (0/1 = off).  N >= 2 builds a
    # (data x model) 2-D mesh and row-shards the decode message state —
    # the final decode AND, in blind mode, the 4-candidate metric decodes
    # (parallel/edge_sharded.py) — over N devices, for codes/batches
    # whose c2v state exceeds one chip's HBM (PEG8064 at B=1024 f32 is
    # 99 MB).  Requires a flooding schedule; data_parallel then sets the
    # data axis (0 = all remaining devices).
    model_parallel: int = 0
    # SNR-point launch folding (0/1 = off).  m >= 2 packs m whole launches
    # — round-robin over the LIVE SNR points — into ONE device dispatch
    # (sim/chain.py make_multi_point_runner): the batched analogue of the
    # reference's one-pool-thread-per-SNR-point concurrency
    # (simulator.cc:27,35-42).  Short many-point sweeps amortize the fixed
    # dispatch overhead m ways; per-point counters are bit-identical to the
    # sequential path for block-capped sweeps (the error-cap rule can
    # overrun by the in-flight slots instead of one launch — same
    # launch-granular divergence class, see sim/montecarlo.py).  Folds
    # histogram and debug_blocks sweeps too (per-point files/chatter
    # demuxed from the slot axis); incompatible only with kmeans_dump_dir
    # and model_parallel.
    snr_fold: int = 0
    # Rayleigh fading per block (reference behavior, simulator.cc:121-123).
    # False pins h = 1 exactly (pure AWGN, driver config #0); the reference
    # has no such switch.
    fading: bool = True
    # Periodic counter checkpoint path ("" disables).
    checkpoint_path: str = ""
    # Seed for jax.random; the reference time-seeds (kmldpc.cpp:22-26).
    seed: int = 0
    # Debug: directory for per-block k-means .mat/.npz dumps in blind mode
    # (KMeans::DumpToMat parity, kmeans.cc:96-111; "" disables).  The first
    # kmeans_dump_blocks blocks of the first launch per SNR point are
    # written.
    kmeans_dump_dir: str = ""
    kmeans_dump_blocks: int = 8
    # Per-block debug chatter (0 disables): log the reference's per-block
    # file-only lines — "Generated H = (re,im)", "Current Block Number",
    # per-candidate "Hhat = ... Metric = ..." and "hatIndex = k"
    # (simulator.cc:124-126, kmcodec.cc:64,132-137) — for the first N
    # blocks of the first launch of each SNR point, to the logfile only.
    debug_blocks: int = 0
    # jax.profiler trace output directory ("" disables). The reference has
    # wall-clock timing only (kmldpc.cpp:11-12); this captures full XLA
    # traces viewable in TensorBoard/Perfetto.
    profile_dir: str = ""


@dataclasses.dataclass(frozen=True)
class Config:
    range: RangeConfig = dataclasses.field(default_factory=RangeConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    xcodec: XCodecConfig = dataclasses.field(default_factory=XCodecConfig)
    histogram: HistogramConfig = dataclasses.field(default_factory=HistogramConfig)
    ldpc: LdpcConfig = dataclasses.field(default_factory=LdpcConfig)
    modem: ModemConfig = dataclasses.field(default_factory=ModemConfig)
    tpu: TpuConfig = dataclasses.field(default_factory=TpuConfig)
    # Directory used to resolve relative asset paths (matrix/modem files).
    asset_dir: str = ""

    def matrix_path(self) -> str:
        return _resolve(self.ldpc.matrix_file, self.asset_dir)

    def modem_path(self) -> str:
        return _resolve(self.modem.modem_file, self.asset_dir)

    def snr_points(self) -> list[float]:
        """The SNR grid; matches `(max-min)/step + 1` (simulator.cc:27)."""
        r = self.range
        n = int((r.maximum_snr - r.minimum_snr) / r.step_snr + 1)
        return [r.minimum_snr + r.step_snr * i for i in range(n)]


def _resolve(path: str, asset_dir: str) -> str:
    if os.path.isabs(path) or not asset_dir:
        return path
    cand = os.path.join(asset_dir, path)
    return cand if os.path.exists(cand) else path


def default_asset_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "assets")


def _build(
    cls,
    name: str,
    table: dict[str, Any],
    renames: dict[str, str] | None = None,
):
    renames = renames or {}
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in table.items():
        key = renames.get(key, key)
        if key not in fields:
            # Valid spellings as the user would write them (e.g. "5gldpc",
            # which is renamed on load because it is not an identifier).
            back = {v: k for k, v in renames.items()}
            valid = sorted(back.get(f, f) for f in fields)
            raise ConfigError(
                f"unknown key {key!r} in [{name}]; valid keys: {', '.join(valid)}"
            )
        kwargs[key] = value
    return cls(**kwargs)


def load_config(path: str, asset_dir: str | None = None) -> Config:
    """Parse a reference-format ``config.toml`` file."""
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    return config_from_dict(raw, asset_dir=asset_dir, config_path=path)


def config_from_dict(
    raw: dict[str, Any],
    asset_dir: str | None = None,
    config_path: str | None = None,
) -> Config:
    if asset_dir is None:
        # Resolve assets next to the config file first, then the bundled dir.
        if config_path is not None:
            cand = os.path.dirname(os.path.abspath(config_path))
            asset_dir = cand
        else:
            asset_dir = default_asset_dir()
    known_tables = ("range", "decoder", "xcodec", "histogram", "ldpc", "modem", "tpu")
    unknown = sorted(set(raw) - set(known_tables))
    if unknown:
        raise ConfigError(
            f"unknown table(s) {', '.join(repr(u) for u in unknown)}; "
            f"valid tables: {', '.join(known_tables)}"
        )
    cfg = Config(
        range=_build(RangeConfig, "range", raw.get("range", {})),
        decoder=_build(DecoderConfig, "decoder", raw.get("decoder", {})),
        # "5gldpc" is not a valid Python identifier — rename on load.
        xcodec=_build(
            XCodecConfig, "xcodec", raw.get("xcodec", {}), {"5gldpc": "ldpc_5g"}
        ),
        histogram=_build(HistogramConfig, "histogram", raw.get("histogram", {})),
        ldpc=_build(LdpcConfig, "ldpc", raw.get("ldpc", {})),
        modem=_build(ModemConfig, "modem", raw.get("modem", {})),
        tpu=_build(TpuConfig, "tpu", raw.get("tpu", {})),
        asset_dir=asset_dir,
    )
    # Fall back to the bundled assets if files are not found beside the config.
    if not os.path.exists(cfg.matrix_path()) or not os.path.exists(cfg.modem_path()):
        bundled = default_asset_dir()
        alt = dataclasses.replace(cfg, asset_dir=bundled)
        if os.path.exists(alt.matrix_path()) and os.path.exists(alt.modem_path()):
            return alt
    return cfg
