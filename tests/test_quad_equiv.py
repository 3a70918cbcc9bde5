"""Matched validation of the PRODUCTION interpolation path.

Every other matched-RNG test detours through the reference-exact
per-time-level interp branch (`interp_wind_legacy`); the quad-corner
row tables (`build_step_tables_quad`) are what production and bench.py
actually run.  These tests pin that path:

- deterministic core: with a zeroed draw table the two interp branches
  must agree to f32 roundoff (time-blend and bilinear interp commute;
  any disagreement is a quad-table indexing/corner-order bug);
- full stochastic step: with real rannumb draws the ONLY remaining
  difference is the wind-sigma estimator (blended 4-sample/3 vs the
  reference 8/16-sample forms, interpol_all.f90:216-240 /
  interpol_wind.f90:194-213), which enters solely through the
  mesoscale term (turbmesoscale=0.16); positions must stay within the
  bound that difference implies;
- the sigma-estimator difference itself is measured and bounded (the
  `core/interp.py` docstring claim is a number, asserted here).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from flexpart_tpu.core.interp import (build_step_tables_quad,
                                      horiz_weights, interp_wind_legacy,
                                      sample_all_quad, vert_weights)
from flexpart_tpu.validation import matched
from flexpart_tpu.validation.legacy_rng import MAXRAND


@pytest.fixture(scope="module")
def met_setup():
    return matched.met_setup()


def _run_pair(grid, z0, z1, x, y, z, nsteps, cfg, prm, table=None):
    """Run the legacy-interp and quad-interp kernels with identical
    particles and identical legacy draw streams."""
    if table is not None:
        orig = matched.make_rannumb
        matched.make_rannumb = lambda n, s: table
    try:
        _, traj_leg = matched.run_kernel_legacy(grid, z0, z1, x, y, z,
                                                nsteps, cfg, prm)
        cfg_q = cfg._replace(legacy_quad=True, met_bf16=False)
        _, traj_quad = matched.run_kernel_legacy(grid, z0, z1, x, y, z,
                                                 nsteps, cfg_q, prm)
    finally:
        if table is not None:
            matched.make_rannumb = orig
    return traj_leg, traj_quad


@pytest.mark.parametrize("turbswitch,ifine", [(True, 4), (False, 1)])
def test_quad_deterministic_core(met_setup, turbswitch, ifine):
    """Zeroed draw table: every stochastic term vanishes, so the quad
    row-table path must reproduce the reference-exact interp branch to
    f32 roundoff — mean winds, density drift, hmix/tropopause/ust/wst/ol
    sampling, vertical reflection and the Petterssen corrector all
    agree (advance.f90:276-615,816-986 deterministic skeleton)."""
    grid, z0, z1, height = met_setup
    cfg, prm, _ = matched.params(grid, turbswitch, ifine)
    n = 28
    x, y, z = matched.start_positions(n)
    zeros = np.zeros(MAXRAND + 1, np.float32)
    traj_leg, traj_quad = _run_pair(grid, z0, z1, x, y, z, 4, cfg, prm,
                                    table=zeros)
    for k in range(len(traj_leg)):
        np.testing.assert_allclose(traj_quad[k][:, 0], traj_leg[k][:, 0],
                                   atol=2e-4, rtol=0,
                                   err_msg=f"x step {k}")
        np.testing.assert_allclose(traj_quad[k][:, 1], traj_leg[k][:, 1],
                                   atol=2e-4, rtol=0,
                                   err_msg=f"y step {k}")
        np.testing.assert_allclose(traj_quad[k][:, 2], traj_leg[k][:, 2],
                                   atol=0.5, rtol=1e-5,
                                   err_msg=f"z step {k}")


def test_quad_full_stochastic_step(met_setup):
    """Real rannumb draws through BOTH interp branches: identical
    Langevin/FT draws, so positions may differ only by the mesoscale
    term driven by the sigma-estimator difference — bounded by
    |dsig| * turbmesoscale * lsync per step (a few hundred metres
    horizontally, i.e. ~1e-2 grid units on the 1-degree test grid)."""
    grid, z0, z1, height = met_setup
    cfg, prm, _ = matched.params(grid, True, 4)
    n = 28
    x, y, z = matched.start_positions(n)
    traj_leg, traj_quad = _run_pair(grid, z0, z1, x, y, z, 4, cfg, prm)
    for k in range(len(traj_leg)):
        np.testing.assert_allclose(traj_quad[k][:, 0], traj_leg[k][:, 0],
                                   atol=5e-2, rtol=0,
                                   err_msg=f"x step {k}")
        np.testing.assert_allclose(traj_quad[k][:, 1], traj_leg[k][:, 1],
                                   atol=5e-2, rtol=0,
                                   err_msg=f"y step {k}")
        np.testing.assert_allclose(traj_quad[k][:, 2], traj_leg[k][:, 2],
                                   atol=30.0, rtol=1e-3,
                                   err_msg=f"z step {k}")


def test_sigma_estimator_bound(met_setup):
    """The production mesoscale sigma is now the reference estimator
    EXACTLY: build_step_tables_quad precomputes the per-cell 8-sample
    std (4 corners x 2 time levels per level, var/7,
    interpol_all.f90:216-240; level pair averaged, advance.f90:601-605)
    on the grid and stores it in quad-table lanes 60-62, so the
    per-particle value matches interp_wind_legacy's 8-sample form to
    f32 roundoff.

    History (round 4): the previous production estimator took the
    4-corner variance of the TIME-BLENDED field (var/3), which loses
    the temporal spread — measured here at up to ~2.4x undershoot for
    the time-evolving v field (median ratio 0.42) and ~8% overshoot
    for the quasi-steady u field.  The per-cell precompute removes
    that bias at zero extra gather cost (the lanes were padding).

    The reference's above-PBL convention pools all 16 samples
    (interpol_wind.f90:194-213) instead of averaging per-level stds,
    so the BETWEEN-level mean difference (vertical shear across the
    bracketing levels) enters as spread.  Production keeps the
    per-level convention everywhere; measured here mid-interval the
    16-sample form is 1.2x (u) / 2.7x (v) the per-level form at the
    median, with a shear-driven tail to ~30x — i.e. above the PBL the
    production mesoscale driver (turbmesoscale=0.16 heuristic)
    wanders less than the reference's wherever the bracketing levels
    shear.  This is the one remaining, quantified convention
    difference on the production interp path; inside the PBL (where
    turbulence actually dominates transport) the conventions are
    identical."""
    grid, z0, z1, height = met_setup
    rs = np.random.RandomState(3)
    n = 4096
    x = jnp.asarray(rs.uniform(1.0, grid.nx - 2.0, n), jnp.float32)
    y = jnp.asarray(rs.uniform(1.0, grid.ny - 2.0, n), jnp.float32)
    z = jnp.asarray(rs.uniform(20.0, 15000.0, n), jnp.float32)

    # mid-interval: equal time weights maximize any blending effect
    tw0 = tw1 = jnp.float32(0.5)
    hw = horiz_weights(x, y, grid.nx, grid.ny, grid.xglobal)
    indz, dz1 = vert_weights(z, z0.height)

    wind_ref, sig16 = interp_wind_legacy(z0, z1, hw, indz, dz1, tw0, tw1)
    tables = build_step_tables_quad(z0, z1, tw0, tw1, tw0, tw1)
    _, _, _, _, _, wind_q = sample_all_quad(tables, hw, indz, dz1, x, y,
                                            grid.nx, grid.ny)

    for name, ref8, ref16, got in (
            ("u", wind_ref.usig, sig16[0], wind_q.usig),
            ("v", wind_ref.vsig, sig16[1], wind_q.vsig),
            ("w", wind_ref.wsig, sig16[2], wind_q.wsig)):
        ref8 = np.asarray(ref8)
        ref16 = np.asarray(ref16)
        got = np.asarray(got)
        # exact match to the reference PBL (8-sample) convention
        np.testing.assert_allclose(got, ref8, rtol=2e-4, atol=1e-6)
        # quantified 8-vs-16-sample convention gap (above-PBL form):
        # median ~1.2 (pooled normalization), tail to ~5x where the
        # bracketing levels shear strongly
        keep = ref8 > 1e-3
        ratio = ref16[keep] / ref8[keep]
        if len(ratio) == 0:
            continue        # w sigma is mm/s-scale on this met
        med = np.median(ratio)
        # measured: u median 1.21 (weak shear), v median 2.68 with a
        # p99 of 33x where the bracketing levels shear hard — the
        # pooled form is an upper envelope of the per-level form
        assert 1.0 < med < 3.5, (name, med)
        assert np.mean(ratio > 0.9) > 0.99, (
            name, np.percentile(ratio, [1, 50, 99]))
