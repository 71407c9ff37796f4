"""Round-2 feature tests: checkpoint-resume stop fidelity, wired Timer
output."""

import re

import numpy as np

from gpusolve_tpu import build_grid, solve
from gpusolve_tpu.config import GridParams, Mode, Stencil


def make_params(**kw):
    defaults = dict(
        maxiter=8,
        tol=1e-12,
        grid_dim=(15, 15, 15),
        mode=Mode.LINEAR,
        pre_smoothing=3,
        post_smoothing=3,
        omega=0.8,
        gamma=1.0,
        stencil=Stencil.poisson_7pt(),
        dtype="float64",
        print_progress=False,
    )
    defaults.update(kw)
    return GridParams(**defaults)


def test_resume_preserves_stop_threshold():
    """A resumed solve must apply the original run's stop threshold
    (res <= initial*tol with the *original* initial), stopping at exactly
    the same cycle as the uninterrupted run (VERDICT r1 item 9)."""
    probe = make_params()
    _, hist = solve(build_grid(probe), probe)
    # Choose tol so the uninterrupted run stops after 5 cycles.
    tol = hist[5] / hist[0] * 1.0001
    p = make_params(maxiter=8, tol=tol)

    _, straight = solve(build_grid(p), p)
    assert len(straight) == 6  # initial + 5 cycles (early stop)

    # Interrupt after 3 cycles, then resume with the original initial.
    p3 = make_params(maxiter=3, tol=tol)
    state, hist1 = solve(build_grid(p3), p3)
    assert len(hist1) == 4  # no early stop yet
    _, hist2 = solve(
        state, make_params(maxiter=8, tol=tol),
        initial_residual=hist1[0],
    )
    combined = hist1 + hist2
    np.testing.assert_allclose(combined, straight, rtol=1e-12)


def test_resume_would_diverge_without_original_initial():
    """Regression guard: recomputing the initial from the resumed state
    (the round-1 behavior) would shift the threshold and run extra cycles."""
    probe = make_params()
    _, hist = solve(build_grid(probe), probe)
    tol = hist[5] / hist[0] * 1.0001
    p3 = make_params(maxiter=3, tol=tol)
    state, hist1 = solve(build_grid(p3), p3)
    # Without the override the threshold becomes hist1[3]*tol which is far
    # below hist[5]: the resumed run must NOT stop at the straight run's
    # stopping cycle.
    _, hist2_wrong = solve(state, make_params(maxiter=8, tol=tol))
    assert len(hist1) - 1 + len(hist2_wrong) - 1 > 5


def test_timer_lines_in_progress_output(capsys):
    """The solve loop prints the reference's Timer suffix format:
    `iter: N residual: R Took Xms, sumBuffer: Yms (Kx), compile: Zms (Mx)`
    (src/Timer.cpp:13-27; compile on the first cycle only)."""
    from gpusolve_tpu.solver import vcycle as vc

    vc._compiled_cycles.clear()  # fresh process = compile on first cycle
    p = make_params(maxiter=2, print_progress=True)
    solve(build_grid(p), p)
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("iter:")]
    assert len(lines) == 2
    assert re.search(
        r"iter: 0 residual: [\d.e+-]+ Took \d+ms.*"
        r"sumBuffer: \d+ms \(1x\)", lines[0]
    )
    assert re.search(r"compile: \d+ms \(1x\)", lines[0])
    # Counters reset after each print; no compile on cycle 1.
    assert "compile" not in lines[1]
    assert re.search(r"sumBuffer: \d+ms \(1x\)", lines[1])


def test_newton_timer_lines(capsys):
    p = make_params(
        maxiter=2, mode=Mode.NEWTON, tol=1e-10, print_progress=True
    )
    from gpusolve_tpu import newton_solve

    newton_solve(build_grid(p), p)
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("newton iter:")]
    assert lines and re.search(
        r"newton iter: 0 residual: [\d.e+-]+ Took \d+ms.*"
        r"sumBuffer: \d+ms \(\d+x\)", lines[0]
    )
