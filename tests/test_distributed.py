"""True multi-process jax.distributed test (2 processes x 2 CPU devices).

SURVEY.md §4 calls for multi-host tests on CPU via jax.distributed; the
virtual-mesh tests (test_parallel.py) cover sharding semantics inside one
process, and this one covers the actual cross-process path: Gloo
collectives, replicated psum'd counters, and the lockstep stopping-rule
contract (every process sees identical global counters).
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, sys.argv[3])
    os.environ["JAX_COORDINATOR_ADDRESS"] = "127.0.0.1:" + sys.argv[2]
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = sys.argv[1]
    from kmldpc_tpu.parallel.distributed import maybe_initialize
    assert maybe_initialize(), "expected multi-process"
    import jax, numpy as np
    assert jax.process_count() == 2 and len(jax.devices()) == 4
    from kmldpc_tpu.code import load_code
    from kmldpc_tpu.io import parse_constellation
    from kmldpc_tpu.parallel import get_mesh, make_sharded_chunk_runner
    from kmldpc_tpu.sim.chain import ChainSpec
    root = sys.argv[3]
    code = load_code(os.path.join(root, "assets", "PEG2304regular0.5.txt"))
    const = parse_constellation(os.path.join(root, "assets", "2bits_QPSK.txt"))
    spec = ChainSpec(code=code, constellation=const, known_h=True, fading=True,
                     metric_type=False, metric_iter=5, max_iter=20,
                     encoder_active=True, histogram=False)
    runner = make_sharded_chunk_runner(spec, batch=16, mesh=get_mesh())
    res = runner(jax.random.key(0), np.float32(10 ** (-1.6)))
    # counters are GLOBAL (psum over the whole 2-process mesh) and identical
    # in every process -- the lockstep stopping-rule contract
    print("RESULT", int(res.tot_blk), int(res.err_blk), int(res.tot_bit), flush=True)
    """
)


_SWEEP_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, sys.argv[3])
    os.environ["JAX_COORDINATOR_ADDRESS"] = "127.0.0.1:" + sys.argv[2]
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = sys.argv[1]
    from kmldpc_tpu.parallel.distributed import maybe_initialize
    assert maybe_initialize(), "expected multi-process"
    import jax
    assert jax.process_count() == 2 and len(jax.devices()) == 4
    root = sys.argv[3]
    from kmldpc_tpu.config import config_from_dict
    from kmldpc_tpu.sim import Simulator
    from kmldpc_tpu.utils.logging import SimLogger
    # Full sweep that STOPS ON THE ERROR CAP at every point (low SNR,
    # Rayleigh fading: most blocks fail).  distributed.py's contract is
    # that the psum'd counters are replicated, so both processes take the
    # same stop decision each launch; a divergent decision would leave one
    # process waiting in a collective forever (deadlock -> test timeout).
    cfg = config_from_dict(dict(
        range=dict(minimum_snr=-2.0, maximum_snr=0.0, step_snr=2.0,
                   maximum_error_number=12, maximum_block_number=10**6),
        decoder=dict(true_h_arg=True),
        ldpc=dict(max_iter=20, active=True,
                  matrix_file="PEG2304regular0.5.txt"),
        modem=dict(modem_file="2bits_QPSK.txt"),
        tpu=dict(batch=16, chunks_per_launch=1),
    ), asset_dir=os.path.join(root, "assets"))
    sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    results = sim.simulate()
    assert all(r.err_blk >= 12 for r in results), "error cap should trigger"
    print("SWEEP " + ";".join(
        f"{r.snr:.3f},{r.tot_blk},{r.err_blk},{r.err_bit}" for r in results
    ), flush=True)
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_counters(tmp_path):
    # bounded by the workers' communicate(timeout=220) below
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), port, root],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=220)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    results = {line for o in outs for line in o.splitlines() if line.startswith("RESULT")}
    # both processes report the same replicated global counters
    assert len(results) == 1, results
    _, tot_blk, err_blk, tot_bit = results.pop().split()
    assert int(tot_blk) == 16
    assert int(tot_bit) == 16 * 1152
    assert int(err_blk) <= 1


def test_two_process_sweep_error_cap_stop(tmp_path):
    """Full 2-process sweep through the Simulator hitting the error-cap
    stopping rule at every SNR point: both processes must take identical
    lockstep stop decisions (a divergence deadlocks the collective and
    times this test out) and report identical final counters
    (simulator.cc:117 semantics; VERDICT r2 weak #5)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "sweep_worker.py"
    worker.write_text(_SWEEP_WORKER)
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), port, root],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    sweeps = {line for o in outs for line in o.splitlines() if line.startswith("SWEEP")}
    assert len(sweeps) == 1, sweeps  # identical counters in both processes
    points = sweeps.pop().split(" ", 1)[1].split(";")
    assert len(points) == 2  # -2 and 0 dB


_FOLDED_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, sys.argv[3])
    os.environ["JAX_COORDINATOR_ADDRESS"] = "127.0.0.1:" + sys.argv[2]
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = sys.argv[1]
    from kmldpc_tpu.parallel.distributed import maybe_initialize
    assert maybe_initialize(), "expected multi-process"
    import jax
    assert jax.process_count() == 2 and len(jax.devices()) == 4
    root = sys.argv[3]
    from kmldpc_tpu.config import config_from_dict
    from kmldpc_tpu.sim import Simulator
    from kmldpc_tpu.utils.logging import SimLogger
    # SNR-point folding over the CROSS-PROCESS mesh, stopping on the
    # error cap: every process assembles its next dispatch's slot list
    # from the replicated psum'd counters, so both must take identical
    # decisions each round (a divergence deadlocks a collective and times
    # the test out).  3 points with fold 2 also forces dead-slot padding
    # on the final dispatches — the round-4 runaway regression, here
    # exercised across processes.
    cfg = config_from_dict(dict(
        range=dict(minimum_snr=-2.0, maximum_snr=2.0, step_snr=2.0,
                   maximum_error_number=12, maximum_block_number=10**6),
        decoder=dict(true_h_arg=True),
        ldpc=dict(max_iter=20, active=True,
                  matrix_file="PEG2304regular0.5.txt"),
        modem=dict(modem_file="2bits_QPSK.txt"),
        tpu=dict(batch=16, chunks_per_launch=1, snr_fold=2),
    ), asset_dir=os.path.join(root, "assets"))
    sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False))
    assert sim.snr_fold == 2
    results = sim.simulate()
    assert all(r.err_blk >= 12 for r in results), "error cap should trigger"
    print("FOLD " + ";".join(
        f"{r.snr:.3f},{r.tot_blk},{r.err_blk},{r.err_bit}" for r in results
    ), flush=True)
    """
)


def test_two_process_folded_sweep(tmp_path):
    """snr_fold across TWO processes: the sharded multi-point runner's
    dispatches span the cross-process mesh and the folded driver's slot
    assembly runs from replicated counters in lockstep; identical final
    counters in both processes, dead-slot padding included."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "folded_worker.py"
    worker.write_text(_FOLDED_WORKER)
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), port, root],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    sweeps = {line for o in outs for line in o.splitlines() if line.startswith("FOLD")}
    assert len(sweeps) == 1, sweeps  # identical counters in both processes
    assert len(sweeps.pop().split(" ", 1)[1].split(";")) == 3


_EDGE_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, sys.argv[3])
    os.environ["JAX_COORDINATOR_ADDRESS"] = "127.0.0.1:" + sys.argv[2]
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = sys.argv[1]
    from kmldpc_tpu.parallel.distributed import maybe_initialize
    assert maybe_initialize(), "expected multi-process"
    import jax, numpy as np
    from jax.sharding import Mesh
    assert jax.process_count() == 2 and len(jax.devices()) == 4
    root = sys.argv[3]
    from kmldpc_tpu.code import load_code
    from kmldpc_tpu.parallel.edge_sharded import make_edge_sharded_decoder
    code = load_code(os.path.join(root, "assets", "PEG2304regular0.5.txt"))
    # mesh spans BOTH processes: the per-iteration posterior psum rides the
    # cross-process Gloo backend (DCN stand-in)
    mesh = Mesh(np.asarray(jax.devices()), ("model",))
    dec = make_edge_sharded_decoder(code, mesh)
    assert dec.num_shards == 4
    rng = np.random.default_rng(1)
    uu = rng.integers(0, 2, size=(4, code.code_dim)).astype(np.uint8)
    cc = np.stack([code.encode_reference(u) for u in uu])
    llr = np.where(cc == 0, 12.0, -12.0).astype(np.float32)
    r = dec(jax.numpy.asarray(llr), 10)
    # uu_hat / converged are replicated -> readable in every process
    assert np.array_equal(np.asarray(r.uu_hat), uu)
    assert np.asarray(r.converged).all()
    print("EDGE " + str(int(np.asarray(r.iters).sum())), flush=True)
    """
)


_MP_CHAIN_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, sys.argv[3])
    os.environ["JAX_COORDINATOR_ADDRESS"] = "127.0.0.1:" + sys.argv[2]
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = sys.argv[1]
    from kmldpc_tpu.parallel.distributed import maybe_initialize
    assert maybe_initialize(), "expected multi-process"
    import jax, numpy as np
    assert jax.process_count() == 2 and len(jax.devices()) == 4
    root = sys.argv[3]
    from jax.sharding import Mesh
    from kmldpc_tpu.code import load_code
    from kmldpc_tpu.io import parse_constellation
    from kmldpc_tpu.parallel.edge_sharded import (
        make_model_parallel_chunk_runner)
    from kmldpc_tpu.sim.chain import ChainSpec
    code = load_code(os.path.join(root, "assets", "PEG2304regular0.5.txt"))
    const = parse_constellation(os.path.join(root, "assets",
                                             "4bit_16QAM_Gray.txt"))
    # BLIND chain with the SOFT metric over a (2 data x 2 model) mesh.
    # jax.devices() orders by process, so the default reshape would keep
    # each model group inside one process; TRANSPOSE it so every model
    # group holds one device from EACH process — the round-5 sharded
    # metric decodes and the two-phase final decode then run their
    # per-iteration posterior psums over the cross-process Gloo backend
    # (the DCN stand-in).
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2).T, ("data", "model"))
    spec = ChainSpec(code=code, constellation=const, known_h=False,
                     fading=True, metric_type=True, metric_iter=3,
                     max_iter=20, encoder_active=True, histogram=False,
                     phase1_iters=3)
    run = make_model_parallel_chunk_runner(spec, 8, mesh)
    res = run(jax.random.key(4), np.float32(10 ** (-2.4)))
    print("MPCHAIN", int(res.tot_blk), int(res.err_blk), int(res.err_bit),
          flush=True)
    """
)


def test_two_process_model_parallel_blind_chain(tmp_path):
    """The FULL blind model-parallel chain across TWO processes (round 5):
    k-means, soft-metric decodes through the row-sharded slab decoder,
    and the two-phase final decode all run over a (data x model) mesh
    whose model-axis psums cross the Gloo process boundary.  Both
    processes must report identical replicated counters."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "mp_chain_worker.py"
    worker.write_text(_MP_CHAIN_WORKER)
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), port, root],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    lines = {line for o in outs for line in o.splitlines()
             if line.startswith("MPCHAIN")}
    assert len(lines) == 1, lines
    _, tot_blk, err_blk, _ = lines.pop().split()
    assert int(tot_blk) == 8
    assert int(err_blk) <= 1  # 24 dB known-good operating point


def test_two_process_edge_sharded_decode(tmp_path):
    """Edge-sharded BP across TWO processes: the message state spans the
    cross-process mesh and each iteration's posterior psum runs over the
    Gloo collective backend (the DCN stand-in).  Both processes must
    decode a noiseless batch to BER 0 and agree on the replicated
    outputs."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "edge_worker.py"
    worker.write_text(_EDGE_WORKER)
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), port, root],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=220)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    digests = {line for o in outs for line in o.splitlines() if line.startswith("EDGE")}
    assert len(digests) == 1, digests
