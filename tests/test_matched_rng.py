"""Matched-RNG validation: the advance kernel vs the scalar oracle.

Kernel and oracle consume bitwise-identical rannumb/ran3 streams, so
any drift is a physics/arithmetic discrepancy, not stochastic spread;
the set-up, the case matrix and the comparison live in
flexpart_tpu.validation.matched (shared with chip_smoke.py).

This is the matched-stream comparison BASELINE.md's correctness row
asks for (gridded concentrations allclose under bitwise-seeded RNG).
"""
import numpy as np
import pytest

from flexpart_tpu.validation import matched


@pytest.fixture(scope="module")
def met_setup():
    return matched.met_setup()


@pytest.mark.parametrize("turbswitch,ifine", [(True, 1), (False, 1),
                                              (True, 4)])
def test_matched_positions(met_setup, turbswitch, ifine):
    run = matched.case_positions(met_setup, turbswitch, ifine)
    # no particle may exit (would desync the host-side nrand chase)
    assert all(s == 0 for s in run.nstops)
    assert bool(np.all(np.asarray(run.pk.active)))
    matched.compare(run)


def test_matched_positions_settling(met_setup):
    """Heavy-aerosol settling active (get_settling.f90 iteration)."""
    run = matched.case_settling(met_setup)
    assert all(s == 0 for s in run.nstops)
    matched.compare(run)


def test_matched_positions_adaptive(met_setup):
    """Adaptive per-particle time stepping (method=1, ctl=5, ifine=2 —
    the Chernobyl-style CTL>=0.1 configuration): the kernel's masked
    while-loop with per-particle nrand cursors must track the oracle's
    serial goto-100 loop (advance.f90:282-609) pass for pass, including
    per-pass vertical re-interpolation, the idt carry-over between sync
    intervals, and mid-interval PBL-exit -> free-troposphere
    completion."""
    run = matched.case_adaptive(met_setup)
    assert all(s == 0 for s in run.nstops)
    assert bool(np.all(np.asarray(run.pk.active)))
    # adaptive runs many substeps per interval -> more f32 roundoff
    # than the fixed-step comparison
    assert (run.atol_xy, run.atol_z) == (2e-2, 5.0)
    matched.compare(run)
    # the stored next-step idt must agree too (it gates the Petterssen
    # corrector and the next interval's first pass)
    idt_k = np.asarray(run.pk.idt)
    idt_o = np.asarray([s["idt"] for s in run.states])
    assert (idt_k == idt_o).mean() > 0.8, (idt_k, idt_o)


def test_matched_concentrations(met_setup):
    """BASELINE.md correctness row at test scale: gridded concentrations
    from kernel and oracle trajectories under matched RNG streams are
    allclose (12 sync steps = a 3-h episode; the binning follows
    conccalc.f90's uniform-kernel nearest-cell rule for young plumes)."""
    run, l1 = matched.case_concentrations(met_setup)
    assert all(s == 0 for s in run.nstops)
    # matched streams: identical trajectories up to f32 roundoff, so the
    # binned fields agree except for particles within roundoff of a cell
    # edge — allow a tiny L1 discrepancy
    assert l1 < 0.02, f"gridded concentration L1 mismatch {l1}"


def test_matched_across_wind_intervals(met_setup):
    """Continue the matched comparison across a getfields buffer swap
    (two 3-h wind intervals, 24 sync steps total): the ran3 chain, the
    turbulence memory, and the interpolation time weights must all
    carry over exactly (timemanager.f90:311-346 memtime rotation)."""
    run = matched.case_wind_intervals(met_setup)
    assert all(s == 0 for s in run.nstops)
    assert bool(np.all(np.asarray(run.pk.active)))
    assert (run.atol_xy, run.atol_z) == (2e-2, 5.0)
    matched.compare(run)


def test_matched_positions_cbl(met_setup):
    """Skewed CBL scheme (CBLFLAG=1): the kernel's masked bi-Gaussian
    drift + re_initialize retry loop + weak-zone Gaussian-raw branch
    against the scalar cbl.f90/re_initialize_particle.f90 oracle under
    bitwise-shared rannumb/ran3 streams, including the fresh-particle
    initialize_cbl_vel draw and the reference's meso-draw-base quirk
    (advance.f90:499 skips the static nrand advance when cblflag=1)."""
    run = matched.case_cbl(met_setup)
    assert all(s == 0 for s in run.nstops)
    assert bool(np.all(np.asarray(run.pk.active)))
    assert (run.atol_xy, run.atol_z) == (5e-3, 2.0)
    matched.compare(run)


def test_max_deviation_reports_worst_live_particle():
    """max_deviation takes the max over steps and live particles only."""
    a = [np.zeros((3, 3)), np.zeros((3, 3))]
    b = [np.zeros((3, 3)), np.array([[0.1, 0.0, 0.0],
                                     [0.0, 0.2, 3.0],
                                     [9.0, 9.0, 9.0]])]
    assert matched.max_deviation(a, b, [0, 0, 1]) == (0.1, 0.2, 3.0)
    run = matched.MatchedRun(None, a, [], [0, 0, 1], b, 5e-3, 2.0)
    with pytest.raises(AssertionError):
        matched.compare(run)
