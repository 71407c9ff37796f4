"""Tooling around the solver: removed CLI values, compile-cache placement,
the benchmark's peak table and trace reducer, and chip_smoke.py's
comparison helpers (called on the CPU at tiny sizes; its ``main`` refuses
a host without a GPU)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from gpusolve_tpu.cli import build_argparser  # noqa: E402
from gpusolve_tpu.utils import compile_cache  # noqa: E402


@pytest.mark.parametrize(
    "argv",
    [
        ["--backend", "pallas"],
        ["--backend", "auto"],
        ["--fuse", "pod"],
        ["--fuse", "leg"],
        ["--fuse", "auto"],
        ["--halo", "rdma"],
        ["--platform", "cpu"],
    ],
    ids=lambda a: "_".join(a).strip("-"),
)
def test_removed_cli_values_rejected_at_parsing(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        build_argparser().parse_args(["x.conf", *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert argv[0] in err or argv[1] in err


def test_kept_backends_parse():
    ap = build_argparser()
    assert ap.parse_args(["x.conf"]).backend == "xla"
    assert ap.parse_args(["x.conf", "--backend", "cpu-native"]).backend == (
        "cpu-native"
    )


def test_compile_cache_defaults_to_checkout_root(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.setup()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert compile_cache.setup() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == old


def test_cli_writes_the_cache_the_env_names(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text(
        "2\n1e-5\n31\n31\n31\n0\n3\n3\n0.8\n1.0\n"
        "6 -1 -1 -1 -1 -1 -1\n0 1 -1 0 0 0 0\n0 0 0 1 -1 0 0\n"
        "0 0 0 0 0 1 -1\n"
    )
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    r = subprocess.run(
        [sys.executable, "-m", "gpusolve_tpu.cli", str(conf), "--quiet"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert any(n.startswith("jit_vcycle") for n in os.listdir(cache))


def test_peak_table_knows_the_h100():
    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"

    assert bench.peak_bandwidth_gbps(Dev()) == 3350.0


@pytest.mark.parametrize(
    "kind", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "", "cpu"]
)
def test_peak_table_rejects_unknown_devices(kind):
    class Dev:
        device_kind = kind

    with pytest.raises(ValueError, match="no published peak"):
        bench.peak_bandwidth_gbps(Dev())


def test_bench_refuses_a_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.require_gpu()


def test_trace_reducer_needs_a_gpu_plane(tmp_path):
    x = jax.numpy.ones((64, 64))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(x * 2.0)
    with pytest.raises(RuntimeError, match="no GPU device plane"):
        bench.device_trace(str(tmp_path))


def test_chip_smoke_refuses_a_cpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert "needs a GPU" in out.err
    assert out.out == ""


def test_chip_smoke_relative_errors():
    ref = np.array([1.0, -4.0, 2.0])
    assert chip_smoke.rel_err(ref + [0.0, 0.04, 0.0], ref) == pytest.approx(
        0.01
    )
    assert chip_smoke.history_rel([10.0, 1.1], [10.0, 1.0]) == pytest.approx(
        0.1
    )
    assert chip_smoke.history_rel([1.0], [1.0, 0.5]) == float("inf")


def test_chip_smoke_f32_comparison_stops_at_the_floor():
    ref = [100.0, 10.0, 1.0, 0.1, 0.01]
    got = [100.0001, 10.0001, 1.05, 0.12, 0.1]
    n, err = chip_smoke.f32_compared(got, ref, margin=10.0)
    assert n == 3  # entries >= 10 x the f32 floor (0.1)
    assert err == pytest.approx(0.05)
    assert chip_smoke.f32_compared([1.0], [1.0], margin=10.0)[0] == 0


@pytest.mark.parametrize(
    "hist, ok",
    [
        ([10.0, 1.0, 0.1], True),
        ([10.0, 1.0, 0.1, 0.105, 0.1], True),  # noise at the floor
        ([10.0, 1.0, 2.0, 0.1], False),
        ([10.0, float("nan"), 0.1], False),
    ],
)
def test_chip_smoke_falling(hist, ok):
    assert chip_smoke.falling(hist) is ok


def test_chip_smoke_printed_history():
    text = (
        "Using config file x\nSolving linear problem\n"
        "Inital residual: 130.1\n"
        "iter: 0 residual: 25.5 Took 3ms, sumBuffer: 2ms (1x)\n"
        "iter: 1 residual: 4.8 Took 3ms\n"
    )
    assert chip_smoke._printed_history(text) == [130.1, 25.5, 4.8]


def test_chip_smoke_op_phase_at_a_tiny_size(monkeypatch, capsys):
    """The per-op phase's comparisons, at 15³ on the CPU."""
    monkeypatch.setattr(chip_smoke, "FULL", (15, 15, 15))
    chip_smoke.phase_ops(jax)
    out = capsys.readouterr().out
    assert out.count("op jacobi") == 3
    assert "0 dot/convolution ops" in out


def test_trace_reducer_on_a_recorded_h100_trace(tmp_path):
    """Two 31³ LINEAR cycles recorded on an H100 with their optimized HLO:
    every kernel lands on the compute stream, and nearly all device time
    maps to a named scope of the cycle."""
    import gzip
    import shutil

    data = os.path.join(REPO, "tests", "data", "h100_linear31")
    run = tmp_path / "plugins" / "profile" / "run"
    run.mkdir(parents=True)
    with gzip.open(os.path.join(data, "trace.xplane.pb.gz")) as src, open(
        run / "t.xplane.pb", "wb"
    ) as dst:
        shutil.copyfileobj(src, dst)
    with gzip.open(os.path.join(data, "vcycle_hlo.txt.gz"), "rt") as f:
        hlo = f.read()
    tr = bench.device_trace(str(tmp_path), hlo)
    assert 0 < tr["busy_ns"] <= tr["window_ns"]
    assert tr["idle_share"] == pytest.approx(
        1 - tr["busy_ns"] / tr["window_ns"]
    )
    for scope in ("smooth", "residual", "restrict", "interpolate",
                  "correct", "norm"):
        assert tr["scopes"].get(scope, 0) > 0, scope
    assert tr["scopes"].get("other", 0) < 0.1 * tr["busy_ns"]
    assert sum(c for c, _, _ in tr["ops"].values()) > 0
