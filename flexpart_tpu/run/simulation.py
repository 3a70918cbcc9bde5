"""The simulation driver — scheduler equivalent of timemanager.f90.

Host-side control loop; ALL per-particle compute stays on device in jitted
kernels.  Per sync interval (timemanager.f90:152-712):

  1. keep two processed wind fields buffered around itime (getfields.f90
     double buffer; here: backend fetch + jitted process_eta/calcpar);
  2. activate scheduled releases (mask flip, core/release.py);
  3. sample concentrations into the device accumulator (conccalc) on the
     loutsample cadence with the reference's half-weight edge rule
     (timemanager.f90:350-365);
  4. at averaging-interval end: normalize (factor3d, concoutput.f90:210-221),
     copy to host, write, zero accumulators;
  5. advance all particles one lsynctime (core/advance.py);
  6. apply decay/terminations.
"""

from __future__ import annotations

import dataclasses
import logging
import time as _time
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AgeClasses, Command, OutGrid, Releases
from ..core import (StepConfig, StepParams, activate, advance_all,
                    build_release_schedule)
from ..core.state import Particles
from ..grid.conccalc import ConcConfig, make_conccalc
from ..grid.fluxes import FluxConfig, make_calcfluxes, zero_flux
from ..grid.receptors import build_receptors, sample_receptors
from ..grid.outgrid import (Accumulators, OutputGridGeometry,
                            zero_accumulators)
from ..io.writer import OutputWriter
from ..met import calcpar, calcpv, compute_heights, process_eta
from ..met.grid import MetGrid
from ..physics import (MassSpecies, WetSpecies, apply_decay_drydep,
                       apply_wetdepo, decay_deposition_grids,
                       make_depokernel, make_vdep_kernel, setup_drydep,
                       wetscav_all)
from ..physics.convection import make_convection_kernel, redist_particles
from ..physics.ohchem import HourlyOH, make_ohreaction, synthetic_oh_field
from ..utils.dates import add_seconds

log = logging.getLogger("flexpart_tpu")


@dataclasses.dataclass
class Simulation:
    cmd: Command
    releases: Releases
    grid: MetGrid
    met_backend: Any              # .fetch(time_seconds) -> EtaFields
    outgrid: OutGrid
    ageclasses: AgeClasses = AgeClasses()
    outdir: str = "output"
    capacity: int | None = None
    nclassunc: int = 1
    seed: int = 1234
    wind_interval: int = 3600     # seconds between met fields
    use_clwc: bool = False
    write_netcdf: bool = True
    write_npz: bool = True
    options_dir: str | None = None   # dir with IGBP/surfdata/surfdepo files
    minmass: float = 1.0e-4          # termination threshold (par_mod.f90)
    oh_field: Any = None             # physics.ohchem.OHField (or None)
    checkpoint_at: int | None = None # write a full checkpoint at this itime
    checkpoint_path: str = "checkpoint.npz"
    receptors: tuple = ()            # config.Receptor points
    outgrid_nest: Any = None         # OUTGRID_NEST (nested output grid)
    met_nests: tuple = ()            # nested met backends (inner last)
    write_fortran: bool = False      # reference-format header + grid_conc_*
    # distributed execution (the timemanager_mpi.f90 analog):
    #   None  - single device
    #   "dp"  - particle data-parallelism over all local devices:
    #           particles sharded along capacity, met fields replicated,
    #           advance under GSPMD (bitwise == the single-device step),
    #           conccalc + deposition scatters into per-device partial
    #           accumulators reduced only at output time
    #           (mpif_tm_reduce_grid, mpi_mod.f90:2395-2503)
    #   "tiles" - met-field domain decomposition: each device owns one
    #           haloed lat/lon tile of the field stack and the particles
    #           inside it; advance/wetdepo/drydepo/conccalc run
    #           tile-locally under shard_map with ppermute migration
    #           between steps (parallel/tiles.py)
    distributed: str | None = None
    n_devices: int | None = None     # cap the mesh size (default: all)
    tile_local_cap: int | None = None  # per-tile particle slots in
    #                                  "tiles" mode (default: planned
    #                                  from the release assignment,
    #                                  plan_tile_capacity); too-small
    #                                  values trigger the dynamic
    #                                  regroup-at-2x rebalance
    turboff: bool = False            # disable all stochastic terms (the
    #                                  reference's TURB_OPTION=0 debug
    #                                  switch); deterministic paths only
    met_bf16: bool = True            # bfloat16 per-step interpolation
    #                                  tables (StepConfig.met_bf16, half
    #                                  the bytes of the row gather);
    #                                  False = f32 interpolation, needed
    #                                  when two differently-compiled
    #                                  programs must produce bit-equal
    #                                  trajectories (XLA excess-precision
    #                                  can elide the bf16 rounding in one
    #                                  fusion context and keep it in
    #                                  another)
    profile: bool = False            # named-section device timing table
    #                                  (mpif_mtime analog; utils/profile)
    trace_dir: str | None = None     # capture a jax.profiler trace here
    legacy_rng: bool = False         # matched-RNG validation mode: every
    #                                  stochastic draw comes from the
    #                                  reference's rannumb table through
    #                                  the serial ran3 nrand chase
    #                                  (FLEXPART.f90:56-59,
    #                                  advance.f90:153) and release
    #                                  positions from the exact ran1
    #                                  order (releaseparticles.f90:
    #                                  147-193) — the production driver
    #                                  becomes stream-matched to the
    #                                  scalar advance.f90 oracle.
    #                                  Single-device only; no nests/CBL
    legacy_seed: int = -7            # idummy seed for the legacy streams
    legacy_trace: bool = False       # record (itime, nrand bases, pre-
    #                                  step positions, active) per step
    #                                  into self._legacy_trace so a test
    #                                  can replay any particle subsample
    #                                  through the scalar oracle with
    #                                  bitwise-identical draws

    def __post_init__(self):
        cmd = self.cmd
        self.nspec = self.releases.nspec
        self.numpoint = self.releases.numpoint
        self.geo = OutputGridGeometry(self.outgrid, self.grid)
        nage = self.ageclasses.nageclass

        # nested met grids, outermost -> innermost (pathnames order,
        # readpaths.f90:45-80); per-particle innermost selection happens
        # in the advance kernel (advance.f90:167-175)
        self.nest_grids = tuple(m.grid for m in self.met_nests)
        self.nest_grid = self.nest_grids[0] if self.nest_grids else None

        # backward deposition modes (readcommand.f90:316-339)
        self.bkdep = (cmd.ind_receptor
                      if cmd.ldirect < 0 and cmd.ind_receptor in (3, 4)
                      else 0)
        self._bkdep_pending = self.bkdep != 0

        sp0 = self.releases.species[0]
        sc = sp0.size_classes()
        # settling is disabled if any release point emits >1 species
        # (readreleases.f90:610-624); otherwise each particle settles
        # with its own species' parameters (advance.f90:518-531)
        lsettling = all(
            sum(1 for m in box.mass if m > 1e-9) <= 1
            for box in self.releases.boxes)
        sp_scs = [s.size_classes() for s in self.releases.species]
        any_settle = any(
            s.density > 0.0 and c is not None
            for s, c in zip(self.releases.species, sp_scs))
        top_lat = self.grid.ylat0 + (self.grid.ny - 1) * self.grid.dy
        self.step_cfg = StepConfig(
            nx=self.grid.nx, ny=self.grid.ny, nz=self.grid.nlev,
            xglobal=self.grid.xglobal,
            polar=bool(self.grid.xglobal
                       and (top_lat > 75.0 or self.grid.ylat0 < -75.0)),
            ldirect=cmd.ldirect,
            turbswitch=cmd.turbswitch, ifine=cmd.ifine_eff,
            method=cmd.method, cblflag=cmd.cblflag == 1,
            nests=tuple((g.nx, g.ny) for g in self.nest_grids),
            nspec=self.nspec,
            settling=lsettling and any_settle,
            turboff=self.turboff,
            met_bf16=self.met_bf16,
        )
        self.step_prm = StepParams.make(
            dx=self.grid.dx, dy=self.grid.dy, ylat0=self.grid.ylat0,
            xlon0=self.grid.xlon0,
            dxconst=self.grid.dxconst, dyconst=self.grid.dyconst,
            lsynctime=cmd.lsynctime, fine=cmd.fine,
            ctl=cmd.ctl_eff, lwindinterv=self.wind_interval,
            sp_density=[max(s.density, -1.0)
                        for s in self.releases.species],
            sp_dquer=[s.dquer for s in self.releases.species],
            sp_cunningham=[c.cunningham if c else 0.0 for c in sp_scs],
            sp_vsetaver=[c.vsetaver if c else 0.0 for c in sp_scs],
            **(dict(
                xln=[(g.xlon0 - self.grid.xlon0) / self.grid.dx
                     for g in self.nest_grids],
                yln=[(g.ylat0 - self.grid.ylat0) / self.grid.dy
                     for g in self.nest_grids],
                xrn=[(g.xlon0 + (g.nx - 1) * g.dx - self.grid.xlon0)
                     / self.grid.dx for g in self.nest_grids],
                yrn=[(g.ylat0 + (g.ny - 1) * g.dy - self.grid.ylat0)
                     / self.grid.dy for g in self.nest_grids],
                xresoln=[self.grid.dx / g.dx for g in self.nest_grids],
                yresoln=[self.grid.dy / g.dy for g in self.nest_grids],
            ) if self.nest_grids else {}),
        )
        self.conc_cfg = ConcConfig(
            nxg=self.geo.nxg, nyg=self.geo.nyg, nzg=self.geo.nzg,
            npointspec=self.numpoint if cmd.ioutputforeachrelease else 1,
            nclassunc=self.nclassunc, nage=nage,
            dxout=self.outgrid.dxout, dyout=self.outgrid.dyout,
            xoutshift=self.geo.xoutshift, youtshift=self.geo.youtshift,
            dx_met=self.grid.dx, dy_met=self.grid.dy,
            ind_samp=cmd.ind_samp,
            ioutputforeachrelease=bool(cmd.ioutputforeachrelease),
            bkdep=self.bkdep != 0,
        )
        self.conccalc = make_conccalc(self.outgrid.outheights)
        # earliest scheduled release (s since bdate) when provable
        # host-side; None (= kernel always possible) for warm starts,
        # domain-filling and backward runs
        self._first_release: int | None = None
        # nested output grid (outgrid_init_nest.f90 / concoutput_nest)
        self.use_nested_output = self.outgrid_nest is not None
        if self.use_nested_output:
            ogn = self.outgrid_nest
            self.geo_n = OutputGridGeometry(ogn, self.grid)
            self.conc_cfg_n = ConcConfig(
                nxg=self.geo_n.nxg, nyg=self.geo_n.nyg, nzg=self.geo_n.nzg,
                npointspec=self.conc_cfg.npointspec,
                nclassunc=self.nclassunc, nage=nage,
                dxout=ogn.dxout, dyout=ogn.dyout,
                xoutshift=self.geo_n.xoutshift,
                youtshift=self.geo_n.youtshift,
                dx_met=self.grid.dx, dy_met=self.grid.dy,
                ind_samp=cmd.ind_samp,
                ioutputforeachrelease=bool(cmd.ioutputforeachrelease))
            self.conccalc_n = make_conccalc(ogn.outheights)
            self.acc_n = zero_accumulators(
                self.geo_n, self.nspec, self.conc_cfg.npointspec,
                self.nclassunc, nage)
            self.writer_n = OutputWriter(
                outdir=self.outdir + "/nest",
                outlon0=ogn.outlon0, outlat0=ogn.outlat0,
                dxout=ogn.dxout, dyout=ogn.dyout,
                outheights=ogn.outheights,
                species_names=tuple(s.name for s in self.releases.species),
                start=cmd.bdate, iout=cmd.iout_eff,
                write_netcdf=self.write_netcdf, write_npz=self.write_npz,
                nc_meta=self._nc_meta(),
                surf_only=bool(cmd.surf_only))
        self.lage = jnp.asarray(
            np.asarray(self.ageclasses.lage or (999999999,), np.int32))

        self._boundary = None     # regional domain-fill boundary state
        if getattr(cmd, "mdomainfill", 0) >= 1:
            # filled from the first wind field at run() start
            # (init_domainfill.f90)
            self.particles = None
        else:
            # warm start (IPIN=1, FLEXPART.f90:322-333): read the
            # previous run's partposit_end from the output dir and
            # append its particles after the scheduled releases
            warm = None
            if cmd.ipin == 1:
                from ..io.partdump import read_partposit
                dump = Path(self.outdir) / "partposit_end"
                if not dump.exists():
                    raise FileNotFoundError(
                        f"IPIN=1 but no {dump} from a previous run "
                        "(readpartpositions.f90)")
                _, warm = read_partposit(str(dump), self.nspec)
            n_warm = len(warm["z"]) if warm else 0
            cap_sched = (None if self.capacity is None
                         else self.capacity - n_warm)
            self.particles = build_release_schedule(
                self.releases, cmd, self.grid, capacity=cap_sched,
                nclassunc=self.nclassunc, seed=self.seed,
                bkdep=self.bkdep)
            if self.legacy_rng:
                self._legacy_release_positions()
            if n_warm:
                self.particles = self._append_warm_start(
                    self.particles, warm)
            elif cmd.ldirect > 0 and self.releases.boxes:
                # host-side bound on the oldest possible particle age:
                # the sampling kernel (conccalc.f90:171 itage>10800)
                # cannot trigger before first_release + 3 h, so the
                # sampler runs its single-index fast path until then
                # (grid/conccalc.py kernel_possible_at)
                self._first_release = min(
                    int((b.start - cmd.bdate).total_seconds())
                    for b in self.releases.boxes)
        self.acc: Accumulators = zero_accumulators(
            self.geo, self.nspec, self.conc_cfg.npointspec,
            self.nclassunc, nage)
        self.writer = OutputWriter(
            outdir=self.outdir,
            outlon0=self.outgrid.outlon0, outlat0=self.outgrid.outlat0,
            dxout=self.outgrid.dxout, dyout=self.outgrid.dyout,
            outheights=self.outgrid.outheights,
            species_names=tuple(s.name for s in self.releases.species),
            start=cmd.bdate, iout=cmd.iout_eff,
            write_netcdf=self.write_netcdf, write_npz=self.write_npz,
            nc_meta=self._nc_meta(),
            surf_only=bool(cmd.surf_only))

        if self.write_fortran:
            self._write_fortran_header()

        self._avg_sums = None            # ipout=3 running sums
        self._avg_counts = None
        self._height = None
        self._buf: dict[int, Any] = {}   # met_time -> ZFields
        self._prefetch: dict[int, Any] = {}  # met_time -> Future(eta)
        self._reader = None              # lazy background reader thread
        self._prefetch_failures = 0      # dead-reader visibility counter
        self._key = jax.random.PRNGKey(self.seed)
        self.timings: dict[str, float] = {}
        from ..utils.profile import SectionTimers
        self.timers = SectionTimers(device_sync=self.profile)
        self.nan_count = 0               # CBL redraws (advance.f90:437)

        # --- deposition / decay setup (wetdepo.f90, getvdep.f90 chain) ---
        species = self.releases.species
        self.wet_species = tuple(WetSpecies.from_species(s)
                                 for s in species)
        self.any_wetdep = any(w.wetdep for w in self.wet_species)
        self.any_drydep = any(s.drydep for s in species)
        self.mass_species = MassSpecies(
            decay=tuple(s.decay for s in species),
            drydep=tuple(s.drydep for s in species),
            minmass=self.minmass)
        self.any_decay = any(s.decay > 0 for s in species)
        self._decay_arr = jnp.asarray([s.decay for s in species],
                                      jnp.float32)
        self._vdep_kernel = None        # built lazily (needs lsm field)
        # OH chemistry is species-activated (readspecies: ohcconst>0)
        self.any_ohreact = any(s.ohreact for s in species)
        if self.any_ohreact:
            if self.oh_field is None:
                log.warning("OH species present but no OH climatology "
                            "given; using the synthetic stand-in field")
                self.oh_field = synthetic_oh_field()
            self._hourly_oh = HourlyOH(self.oh_field, cmd.bdate,
                                       cmd.ldirect)
            self._ohreaction = make_ohreaction(self.oh_field, self.grid,
                                               species)
        self.use_convection = cmd.lconvection == 1
        if self.use_convection:
            self.conv_kernel = make_convection_kernel(self.grid)
            self.cbmf = jnp.zeros(self.grid.ny * self.grid.nx, jnp.float32)
        # receptor sampling (conccalc.f90:430-498)
        self.receptor_set, self.receptor_names = build_receptors(
            self.receptors, self.grid)
        if self.receptor_set is not None:
            self.creceptor = jnp.zeros(
                (len(self.receptor_names), self.nspec), jnp.float32)
        # gross flux diagnostics (iflux=1; calcfluxes.f90)
        self.use_flux = getattr(cmd, "iflux", 0) == 1
        if self.use_flux:
            self.flux_cfg = FluxConfig(
                nxg=self.geo.nxg, nyg=self.geo.nyg, nzg=self.geo.nzg,
                npointspec=self.numpoint if cmd.ioutputforeachrelease
                else 1,
                nage=nage, dxout=self.outgrid.dxout,
                dyout=self.outgrid.dyout, xoutshift=self.geo.xoutshift,
                youtshift=self.geo.youtshift, dx_met=self.grid.dx,
                dy_met=self.grid.dy, nx_met=self.grid.nx)
            self.flux = zero_flux(self.flux_cfg, self.nspec)
            self._calcfluxes = make_calcfluxes(self.outgrid.outheights)
        # plume-centroid trajectories (iout=4/5; plumetraj.f90)
        self.use_plumetraj = cmd.iout_eff in (4, 5)
        if self.use_plumetraj:
            from ..grid.plumetraj import PlumeTrajWriter
            from pathlib import Path as _P
            self._plume_writer = PlumeTrajWriter(
                _P(self.outdir) / "trajectories.txt", self.releases,
                cmd.bdate)
        # sensitivity to initial conditions (linit_cond,
        # initial_cond_calc.f90)
        self.use_initcond = cmd.linit_cond >= 1
        if self.use_initcond:
            from ..grid.initcond import (InitCondConfig,
                                         make_initcond_scatter,
                                         zero_init_cond)
            self.ic_cfg = InitCondConfig(
                nxg=self.geo.nxg, nyg=self.geo.nyg, nzg=self.geo.nzg,
                npointspec=self.conc_cfg.npointspec,
                dxout=self.outgrid.dxout, dyout=self.outgrid.dyout,
                xoutshift=self.geo.xoutshift,
                youtshift=self.geo.youtshift,
                dx_met=self.grid.dx, dy_met=self.grid.dy,
                linit_cond=cmd.linit_cond,
                ioutputforeachrelease=bool(cmd.ioutputforeachrelease))
            self.init_cond = zero_init_cond(self.ic_cfg, self.nspec)
            self._ic_scatter = make_initcond_scatter(
                self.outgrid.outheights)
            rm = np.zeros((self.conc_cfg.npointspec, self.nspec),
                          np.float32)
            for b_idx, b in enumerate(self.releases.boxes):
                kp = b_idx if cmd.ioutputforeachrelease else 0
                for k in range(self.nspec):
                    rm[kp, k] += b.mass[k] if k < len(b.mass) else 0.0
            self._release_mass = rm
        cc = self.conc_cfg
        self.depo_scatter = make_depokernel(
            cc.nxg, cc.nyg, cc.npointspec, cc.nclassunc, cc.nage,
            cc.dxout, cc.dyout, cc.xoutshift, cc.youtshift,
            cc.dx_met, cc.dy_met)

        # ----- distributed mode (timemanager_mpi.f90 analog) -----
        self._mesh = None
        self._tiles = None
        self._tile_defer_streak = 0
        if self.distributed == "tiles":
            # domain-decomposed met fields + tile-owned particles
            # (SURVEY §2.8 "met-field domain decomposition"; the full
            # timemanager_mpi.f90:211-858 loop on tiles)
            from ..parallel.tiles import (TiledEngine, choose_tile_mesh,
                                          make_tiled_conccalc,
                                          make_tiled_decay_drydep,
                                          make_tiled_depo_scatter,
                                          make_tiled_wetscav, tile_mesh,
                                          zero_tile_acc_partials)
            # Supported in tiles mode: convection, OH chemistry,
            # receptors and gross fluxes run on the SHARDED particle
            # buffers with replicated auxiliary fields — GSPMD inserts
            # the cross-device reductions (receptor sampling is a
            # matmul over the particle axis; convective redistribution
            # only changes z, preserving the tile-ownership
            # invariant).  Splitting allocates slots tile-locally
            # (make_tiled_split); flux/init-cond scatters use the
            # pre-migration state (make_tiled_advance return_pre).
            # Matches timemanager_mpi.f90:211-858 which runs the full
            # physics set per rank (redist_mpi.f90, mpi_mod.f90:
            # 2459-2475 receptor reduce).
            unsupported = []
            if self.met_nests:
                unsupported.append("nested met grids")
            if self.bkdep:
                unsupported.append("backward deposition modes")
            if unsupported:
                raise ValueError(
                    "distributed='tiles' does not support: "
                    + ", ".join(unsupported)
                    + " (use distributed='dp' for these)")
            ndev = self.n_devices or len(jax.devices())
            nty, ntx = choose_tile_mesh(ndev, self.grid.ny,
                                        self.grid.nxfield)
            from ..parallel.domain import halo_for
            # halo from the ACTUAL first-interval max wind (+25%
            # gust/meso margin), not a hardcoded cap; the probed read is
            # stashed as a completed prefetch so the first _get_field
            # reuses it
            umax = 100.0
            try:
                t0p = 0 if cmd.ldirect > 0 else -self.wind_interval
                eta_p, etan_p = self._fetch_raw(t0p)
                umax = 1.25 * float(max(np.abs(eta_p.uuh).max(),
                                        np.abs(eta_p.vvh).max()))
                import concurrent.futures as _cf
                fut = _cf.Future()
                fut.set_result(("raw", (eta_p, etan_p)))
                self._prefetch[t0p] = fut
            except Exception:
                log.warning("met probe for halo sizing failed; using "
                            "the 100 m/s cap", exc_info=True)
            tx_c = -(-self.grid.nxfield // ntx)
            ty_c = -(-self.grid.ny // nty)
            halo = max(2, min(
                halo_for(umax, cmd.lsynctime, self.grid.dx),
                tx_c - 1, ty_c - 1))
            mesh = tile_mesh(nty, ntx)
            eng = TiledEngine(mesh, self.step_cfg, self.grid,
                              nty, ntx, halo,
                              return_pre=(self.use_flux
                                          or self.use_initcond))
            self._tiles = eng
            self._mesh = mesh
            if self.particles is not None:
                self.particles = eng.shard_initial(self.particles,
                                                   self.tile_local_cap)
            self.acc = zero_tile_acc_partials(
                mesh, self.geo, self.nspec, self.conc_cfg.npointspec,
                self.nclassunc, nage)
            cc_t = make_tiled_conccalc(
                mesh, self.outgrid.outheights, self.conc_cfg,
                eng.tx, eng.ty, halo, has_vdep=self.any_drydep)
            self.conccalc = (
                lambda acc, p, zf, it, lage, w, cfg, _f=cc_t:
                _f(acc, p, zf, it, lage, w))
            if self.use_nested_output:
                cc_tn = make_tiled_conccalc(
                    mesh, self.outgrid_nest.outheights, self.conc_cfg_n,
                    eng.tx, eng.ty, halo, has_vdep=self.any_drydep)
                self.conccalc_n = (
                    lambda acc, p, zf, it, lage, w, cfg, _f=cc_tn:
                    _f(acc, p, zf, it, lage, w))
                self.acc_n = zero_tile_acc_partials(
                    mesh, self.geo_n, self.nspec,
                    self.conc_cfg.npointspec, self.nclassunc, nage)
            if self.any_wetdep:
                self._tiled_wetscav = make_tiled_wetscav(
                    mesh, self.wet_species, self.use_clwc,
                    eng.tx, eng.ty, halo, has_vdep=self.any_drydep)
            if self.any_drydep or self.any_decay:
                self._tiled_drydep = make_tiled_decay_drydep(
                    mesh, self.mass_species, self.any_drydep,
                    eng.tx, eng.ty, halo, z_has_vdep=self.any_drydep)
            self.depo_scatter = make_tiled_depo_scatter(
                mesh, self.depo_scatter)
            log.info("distributed tiles: %dx%d mesh, %dx%d-cell tiles, "
                     "halo %d", nty, ntx, eng.ty, eng.tx, halo)
        elif self.distributed == "dp":
            from ..parallel import (make_sharded_conccalc,
                                    make_sharded_depo_scatter,
                                    pad_particles, particle_mesh,
                                    shard_particles, zero_acc_partials)
            self._mesh = particle_mesh(self.n_devices)
            ndev = self._mesh.devices.size
            if self.capacity is not None:
                self.capacity = -(-self.capacity // ndev) * ndev
            if self.particles is not None:
                self.particles = shard_particles(
                    pad_particles(self.particles, ndev), self._mesh)
            # per-device partial accumulators, reduced only at output
            self.acc = zero_acc_partials(
                self._mesh, self.geo, self.nspec,
                self.conc_cfg.npointspec, self.nclassunc, nage)
            cc_m = make_sharded_conccalc(
                self._mesh, self.outgrid.outheights, self.conc_cfg)
            self.conccalc = (
                lambda acc, p, zf, it, lage, w, cfg, _f=cc_m:
                _f(acc, p, zf, it, lage, w))
            if self.use_nested_output:
                cc_n = make_sharded_conccalc(
                    self._mesh, self.outgrid_nest.outheights,
                    self.conc_cfg_n)
                self.conccalc_n = (
                    lambda acc, p, zf, it, lage, w, cfg, _f=cc_n:
                    _f(acc, p, zf, it, lage, w))
                self.acc_n = zero_acc_partials(
                    self._mesh, self.geo_n, self.nspec,
                    self.conc_cfg.npointspec, self.nclassunc, nage)
            self.depo_scatter = make_sharded_depo_scatter(
                self._mesh, self.depo_scatter)
            log.info("distributed particle-DP over %d devices", ndev)


    def _nc_meta(self) -> dict:
        """Reference-layout netCDF-4 metadata (netcdf_output_mod.f90:
        writemetadata + the RELCOM/RELLNG/RELZZ/RELPART release block +
        per-species physics attributes + output_units table)."""
        cmd = self.cmd
        rel = self.releases
        # output units (Stohl et al. 2005 table 1; output_units())
        if cmd.ldirect == 1:
            units = "ng m-3" if cmd.ind_receptor == 1 else "ng kg-1"
        else:
            if cmd.ind_source == 1:
                units = "s" if cmd.ind_receptor == 1 else "s m3 kg-1"
            else:
                units = "s kg m-3" if cmd.ind_receptor == 1 else "s"
        prefix = "grid_conc_" if cmd.ldirect == 1 else "grid_time_"
        if self.bkdep == 3:
            prefix = "grid_wetdep_"
        elif self.bkdep == 4:
            prefix = "grid_drydep_"
        t0 = cmd.bdate
        relstart = [int((b.start - t0).total_seconds()) for b in rel.boxes]
        relend = [int((b.end - t0).total_seconds()) for b in rel.boxes]
        nspec = rel.nspec
        xmass = np.zeros((nspec, rel.numpoint), np.float32)
        for j, b in enumerate(rel.boxes):
            for ks in range(min(nspec, len(b.mass))):
                xmass[ks, j] = b.mass[ks]
        species = []
        for s in rel.species:
            species.append(dict(
                decay=float(s.decay), weightmolar=float(s.weightmolar),
                ohcconst=float(s.ohcconst), ohdconst=float(s.ohdconst),
                vsetaver=0.0,
                weta_gas=float(s.weta_gas), wetb_gas=float(s.wetb_gas),
                ccn_aero=float(s.ccn_aero), in_aero=float(s.in_aero),
                dquer=float(s.dquer), henry=float(s.henry),
                dryvel=float(s.dryvel), reldiff=float(s.reldiff),
                f0=float(s.f0), density=float(s.density),
                dsigma=float(s.dsigma)))
        return {
            "prefix": prefix,
            "units": units,
            "lage": list(self.ageclasses.lage or (999999999,)),
            "global": {
                "ldirect": int(cmd.ldirect),
                "ibdate": f"{cmd.ibdate:08d}", "ibtime": f"{cmd.ibtime:06d}",
                "iedate": f"{cmd.iedate:08d}", "ietime": f"{cmd.ietime:06d}",
                "loutstep": int(cmd.loutstep),
                "loutaver": int(cmd.loutaver),
                "loutsample": int(cmd.loutsample),
                "itsplit": int(cmd.itsplit),
                "lsynctime": int(cmd.lsynctime),
                "ctl": float(cmd.ctl), "ifine": int(cmd.ifine),
                "iout": int(cmd.iout), "ipout": int(cmd.ipout),
                "lsubgrid": int(cmd.lsubgrid),
                "lconvection": int(cmd.lconvection),
                "lagespectra": int(cmd.lagespectra),
                "ipin": int(cmd.ipin),
                "ioutputforeachrelease": int(cmd.ioutputforeachrelease),
                "iflux": int(cmd.iflux),
                "mdomainfill": int(getattr(cmd, "mdomainfill", 0)),
                "ind_source": int(cmd.ind_source),
                "ind_receptor": int(cmd.ind_receptor),
                "mquasilag": int(cmd.mquasilag),
                "nested_output": int(self.outgrid_nest is not None),
                "surf_only": int(cmd.surf_only),
                "linit_cond": int(getattr(cmd, "linit_cond", 0)),
            },
            "releases": {
                "names": [b.comment for b in rel.boxes],
                "RELLNG1": [b.lon1 for b in rel.boxes],
                "RELLNG2": [b.lon2 for b in rel.boxes],
                "RELLAT1": [b.lat1 for b in rel.boxes],
                "RELLAT2": [b.lat2 for b in rel.boxes],
                "RELZZ1": [b.z1 for b in rel.boxes],
                "RELZZ2": [b.z2 for b in rel.boxes],
                "RELKINDZ": [b.zkind for b in rel.boxes],
                "RELSTART": relstart,
                "RELEND": relend,
                "RELPART": [b.parts for b in rel.boxes],
                "RELXMASS": xmass,
            },
            "species": species,
        }

    def _ensure_vdep_kernel(self, eta):
        if self._vdep_kernel is not None or not self.any_drydep:
            return
        species = self.releases.species
        needs_tables = any(s.reldiff > 0 or (s.density > 0 and s.dquer > 0)
                           for s in species)
        if needs_tables and self.options_dir is not None:
            mmdd = self.cmd.bdate.month * 100 + self.cmd.bdate.day
            td = setup_drydep(self.options_dir, self.grid, species,
                              np.asarray(eta.lsm), mmdd)
            self._vdep_kernel = make_vdep_kernel(td)
        else:
            # constant-velocity fallback only (getvdep.f90:196-203)
            dryvel = np.asarray([max(s.dryvel, 0.0) for s in species],
                                np.float32)

            def const_kernel(ust, tt2, rh, ps, oli, ssr, precip, sd,
                             _dv=jnp.asarray(dryvel)):
                ny, nx = ust.shape
                return jnp.broadcast_to(_dv[:, None, None],
                                        (_dv.shape[0], ny, nx))

            self._vdep_kernel = const_kernel

    # ----- met double buffer (getfields.f90:93-196 analog) -----
    def _fetch_raw(self, tsec: int):
        """Host-side met read+assembly for one wind time (the expensive,
        device-free part of getfields)."""
        eta = self.met_backend.fetch(float(tsec))
        etan = tuple(m.fetch(float(tsec)) for m in self.met_nests) \
            if self.met_nests else None
        return eta, etan

    def _prefetch_job(self, tsec: int):
        """Worker-thread body: host read + (when the one-time state —
        height grid, vdep kernel — already exists) the FULL device
        processing pipeline, so the next field is buffer-ready when the
        step loop asks for it.  Returns ("processed", entry) or
        ("raw", (eta, etan))."""
        tf0 = _time.perf_counter()
        eta, etan = self._fetch_raw(tsec)
        self.timers.add("getfields_fetch_bg", _time.perf_counter() - tf0)
        ready = (self._height is not None and self.bkdep != 3
                 and (self._vdep_kernel is not None
                      or not self.any_drydep))
        if ready:
            tp0 = _time.perf_counter()
            out = "processed", self._process_field(tsec, eta, etan)
            self.timers.add("getfields_proc_bg",
                            _time.perf_counter() - tp0)
            return out
        return "raw", (eta, etan)

    def _prefetch_async(self, tsec: int):
        """Schedule a background read+preprocess of a future wind time —
        the reference's dedicated MPI reader rank with numwfmem=3
        (mpi_mod.f90:1598-2392, README_PARALLEL.md:96-106) becomes one
        daemon thread overlapping host GRIB decode/assembly AND the
        calcpar/verttransform/transfer pipeline with device compute
        (measured on the REF1-scale e2e bench: getfields wall went from
        ~2/3 of the run to near-hidden)."""
        if tsec in self._buf or tsec in self._prefetch:
            return
        try:
            import concurrent.futures
            if self._reader is None:
                self._reader = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="metreader")
            self._prefetch[tsec] = self._reader.submit(
                self._prefetch_job, tsec)
        except Exception:
            # reader thread unavailable: the run degrades to
            # synchronous reads in _get_field — make that VISIBLE
            # (a dead reader silently costs the async-getfields overlap)
            self._prefetch_failures += 1
            log.warning("met prefetch submission failed for t=%ss "
                        "(failure #%d); falling back to synchronous "
                        "reads", tsec, self._prefetch_failures,
                        exc_info=True)

    def _get_field(self, tsec: int):
        if tsec not in self._buf:
            t0 = _time.perf_counter()
            fut = self._prefetch.pop(tsec, None)
            etan_pre = None
            processed = None
            eta = None
            if fut is not None:
                try:
                    tag, payload = fut.result()
                    if tag == "processed":
                        processed = payload
                        eta = payload[1]
                    else:
                        eta, etan_pre = payload
                except Exception:
                    self._prefetch_failures += 1
                    log.warning("met prefetch for t=%ss died in the "
                                "reader thread (failure #%d); reading "
                                "synchronously", tsec,
                                self._prefetch_failures, exc_info=True)
                    eta = self.met_backend.fetch(float(tsec))
            else:
                eta = self.met_backend.fetch(float(tsec))
            if self.bkdep == 3:
                # release-point precip series (getfields.f90:141-143)
                from pathlib import Path as _P
                from ..physics.bkdep import write_precip
                write_precip(_P(self.outdir) / "wetscav_precip.txt",
                             add_seconds(self.cmd.bdate, tsec),
                             self.releases, self.grid, eta,
                             first=not getattr(self, "_precip_started",
                                               False))
                self._precip_started = True
            if self._height is None:
                self._height = compute_heights(self.grid, eta)
                # output-grid orography for the netCDF header (ORO var,
                # netcdf_output_mod.f90:528-535 <- outgrid_init.f90:107-181)
                try:
                    from ..grid.outgrid import oro_outgrid
                    oro = oro_outgrid(self.geo, np.asarray(eta.oro))
                    if self.writer.nc_meta is not None:
                        self.writer.nc_meta["oro"] = oro
                    if self.use_nested_output \
                            and self.writer_n.nc_meta is not None:
                        self.writer_n.nc_meta["oro"] = oro_outgrid(
                            self.geo_n, np.asarray(eta.oro))
                except AttributeError:
                    pass             # met backend without an oro field
            # keep at most 3 buffered fields, evicting the one FARTHEST
            # from the requested time — direction-aware, so backward
            # (ldirect=-1) runs retire stale post-t=0 fields instead of
            # the freshly prefetched earlier ones (the memind rotation
            # of getfields.f90:93-113 works both ways)
            while len(self._buf) >= 3:
                farthest = max(self._buf, key=lambda k: abs(k - tsec))
                del self._buf[farthest]
            self._buf[tsec] = (processed if processed is not None
                               else self._process_field(tsec, eta,
                                                        etan_pre))
            dt_gf = _time.perf_counter() - t0
            self.timers.add("getfields", dt_gf)
            log.debug("getfields t=%ss: %.2fs blocked (%s)", tsec, dt_gf,
                      "prefetched" if processed is not None else "sync")
        return self._buf[tsec][0]

    def _process_field(self, tsec: int, eta, etan_pre):
        """Device-side processing of one fetched met time: calcpv +
        verttransform + calcpar (+ nests, + tile decompose / dp
        replicate).  Returns the (z, eta, zn, zt) buffer entry.  Safe
        to call from the prefetch worker thread once the height grid /
        vdep kernel exist — the ASYNC READER then overlaps the whole
        read+preprocess+transfer pipeline with particle advance, not
        just the host read (getfields_mpi.f90 reader-rank semantics:
        readwind -> calcpar -> verttransform all happen off the
        compute ranks)."""
        self._ensure_vdep_kernel(eta)
        pvh = calcpv(self.grid, eta)
        z = process_eta(self.grid, eta, self._height, pvh=pvh,
                        use_clwc=self.use_clwc)
        z = calcpar(self.grid, eta, z,
                    lsubgrid=bool(self.cmd.lsubgrid),
                    vdep_kernel=self._vdep_kernel)
        # nested met fields, processed onto the SAME height grid
        # (verttransform_nests.f90 contract)
        zn = None
        if self.met_nests:
            etans = (etan_pre if etan_pre is not None
                     else tuple(m.fetch(float(tsec))
                                for m in self.met_nests))
            zn = []
            for g, etan in zip(self.nest_grids, etans):
                pvn = calcpv(g, etan)
                znk = process_eta(g, etan, self._height,
                                  pvh=pvn, use_clwc=self.use_clwc)
                zn.append(calcpar(g, etan, znk,
                                  lsubgrid=bool(self.cmd.lsubgrid)))
            zn = tuple(zn)
        zt = None
        if self._tiles is not None:
            # host-side tiling + one placement per wind read (the
            # field-distribution analog of mpif_gf_send_vars)
            zt = self._tiles.decompose(z)
        elif self._mesh is not None:
            # replicate once per wind field so every jitted step sees
            # mesh-committed inputs (mpif_gf_send_vars analog — one
            # broadcast per field read, not per step)
            from ..parallel import replicate
            z = replicate(z, self._mesh)
            if zn is not None:
                zn = replicate(zn, self._mesh)
        # convection needs the raw eta-level profiles too
        # (convmix.f90:168-189)
        return (z, eta, zn, zt)

    def _get_eta(self, tsec: int):
        self._get_field(tsec)
        return self._buf[tsec][1]

    def _get_nest(self, tsec: int):
        self._get_field(tsec)
        return self._buf[tsec][2]

    def _ccfg_at(self, itime, base):
        """Sampling config for this step: drops to the single-index
        direct-only scatter while no particle can be >= 3 h old
        (conccalc.f90:171; one recompile when the plume crosses 3 h)."""
        from ..grid.conccalc import kernel_possible_at
        kp = kernel_possible_at(itime, self._first_release,
                                base.use_kernel)
        if kp == base.kernel_possible:
            return base
        return base._replace(kernel_possible=kp)

    def _get_tiles(self, tsec: int):
        """Tiled field stack for this wind time (tiles mode only)."""
        self._get_field(tsec)
        return self._buf[tsec][3]

    def _fields_for(self, itime: int):
        wi = self.wind_interval
        t0 = (itime // wi) * wi
        if itime % wi == 0 and self.cmd.ldirect < 0:
            t0 = itime - wi
        t1 = t0 + wi
        f0, f1 = self._get_field(t0), self._get_field(t1)
        # read the NEXT field in the background while particles advance
        tn = t1 + wi if self.cmd.ldirect > 0 else t0 - wi
        if abs(tn) <= abs(self.cmd.ideltas) + wi:
            self._prefetch_async(tn)
        return f0, f1, t0, t1

    def _append_warm_start(self, p, warm):
        """Append partposit_end particles (readpartpositions.f90:100-131)
        after the scheduled-release slots: itra=0 so they resume at the
        first step; itramem keeps the original (pre-resume) release time
        so age classes stay correct; turbulence memory is re-drawn by
        the fresh-particle block of the first advance (itime==0)."""
        import numpy as np
        n = len(warm["z"])
        rng_w = np.random.default_rng(self.seed + 101)
        x = ((warm["lon"] - self.grid.xlon0) / self.grid.dx) \
            .astype(np.float32)
        y = ((warm["lat"] - self.grid.ylat0) / self.grid.dy) \
            .astype(np.float32)
        zf = jnp.zeros(n, jnp.float32)
        extra = p.__class__(
            x_hi=jnp.asarray(x), x_lo=zf, y_hi=jnp.asarray(y), y_lo=zf,
            z=jnp.asarray(warm["z"].astype(np.float32)),
            itra=jnp.zeros(n, jnp.int32),
            itramem=jnp.asarray(warm["itramem"].astype(np.int32)),
            npoint=jnp.asarray(warm["npoint"].astype(np.int32)),
            nclass=jnp.asarray(rng_w.integers(
                0, self.nclassunc, size=n).astype(np.int32)),
            idt=jnp.zeros(n, jnp.int32),
            itrasplit=jnp.full(n, 999999999, jnp.int32),
            up=zf, vp=zf, wp=zf, usig=zf, vsig=zf, wsig=zf,
            cbt=jnp.ones(n, jnp.int8),
            mass=jnp.asarray(warm["mass"].astype(np.float32)),
            mass0=jnp.asarray(warm["mass"].astype(np.float32)),
            xscav=jnp.ones((n, self.nspec), jnp.float32),
            active=jnp.zeros(n, bool),
        )
        merged = p.__class__(*[jnp.concatenate([a, b], axis=0)
                               for a, b in zip(p, extra)])
        log.info("warm start: %d particles resumed from partposit_end",
                 n)
        return merged

    def close(self):
        """Stop the background met reader: drop pending prefetches (and
        retrieve their exceptions) so interpreter exit isn't delayed by
        reads past the run end."""
        for fut in self._prefetch.values():
            fut.cancel()
            if fut.done() and not fut.cancelled():
                fut.exception()          # consume, don't raise
        self._prefetch.clear()
        if self._reader is not None:
            self._reader.shutdown(wait=False, cancel_futures=True)
            self._reader = None
        self.writer.close()
        if self.use_nested_output:
            self.writer_n.close()

    # ----- main loop -----
    def run(self, progress: bool = False, start_itime: int = 0):
        try:
            if self.trace_dir:
                with jax.profiler.trace(str(self.trace_dir)):
                    return self._run(progress, start_itime)
            return self._run(progress, start_itime)
        finally:
            self.close()

    def _run(self, progress: bool = False, start_itime: int = 0):
        cmd = self.cmd
        lsync = cmd.lsynctime * cmd.ldirect
        ideltas = cmd.ideltas
        loutnext = cmd.loutstep * cmd.ldirect
        loutaver = cmd.loutaver * cmd.ldirect
        loutstart = loutnext - loutaver // 2
        loutend = loutnext + loutaver // 2
        loutsample = cmd.loutsample * cmd.ldirect

        nsteps = abs(ideltas) // abs(lsync)
        t_wall0 = _time.perf_counter()
        particle_steps = 0

        if self.legacy_rng:
            # matched-RNG mode: one shared ran3 idummy chain feeds the
            # per-particle nrand bases in reference consumption order
            # (FLEXPART.f90:56-59 table; advance.f90:153 chase)
            from ..validation.legacy_rng import (MAXRAND, NrandStream,
                                                 make_rannumb)
            if self.distributed is not None:
                raise ValueError("legacy_rng is single-device only")
            if self.met_nests:
                raise ValueError("legacy_rng does not support nests")
            if start_itime != 0:
                raise ValueError("legacy_rng cannot resume mid-run "
                                 "(the serial idummy chain has no "
                                 "checkpoint)")
            self._legacy_table = jnp.asarray(
                make_rannumb(MAXRAND, self.legacy_seed))
            self._legacy_stream = NrandStream(self.legacy_seed, MAXRAND)

        if self.particles is None:
            from ..core.domainfill import init_domainfill
            zf = self._get_field(0)
            box = self.releases.boxes[0]
            npart_target = box.parts
            window = (
                (box.lon1 - self.grid.xlon0) / self.grid.dx,
                (box.lon2 - self.grid.xlon0) / self.grid.dx,
                (box.lat1 - self.grid.ylat0) / self.grid.dy,
                (box.lat2 - self.grid.ylat0) / self.grid.dy,
            )
            (self.particles, self.airmass_total,
             self._boundary) = init_domainfill(
                self.grid, zf, npart_target,
                mdomainfill=cmd.mdomainfill, nclassunc=self.nclassunc,
                seed=self.seed, capacity=self.capacity, window=window)
            log.info("domain-filling: %d particles, total air mass "
                     "%.3e kg%s", self.particles.capacity,
                     self.airmass_total,
                     "" if self._boundary is None
                     else " (regional window + boundary conditions)")
            if self._tiles is not None:
                # tiles mode (init_domainfill_mpi.f90 analog): group
                # the filled population by owning tile, partition the
                # boundary-site table tile-locally, and build the
                # shard_map'd boundary-condition step
                from ..parallel.tiles import (make_tiled_boundcond,
                                              partition_boundary)
                eng = self._tiles
                self.particles = eng.shard_initial(self.particles,
                                                   self.tile_local_cap)
                if self._boundary is not None:
                    self._boundary = jax.device_put(
                        partition_boundary(
                            self._boundary, eng.nty, eng.ntx, eng.tx,
                            eng.ty, eng.halo, self.grid.nx),
                        eng.sharding)
                    self._tiled_boundcond = make_tiled_boundcond(
                        eng.mesh, eng.ntx, cmd.mdomainfill,
                        cmd.ldirect, self.nclassunc,
                        check_x=not (self.grid.xglobal and float(
                            self._boundary.xlim[0, 1])
                            == self.grid.nx - 2),
                        has_vdep=self.any_drydep)
            elif self._mesh is not None:
                from ..parallel import pad_particles, shard_particles
                self.particles = shard_particles(
                    pad_particles(self.particles,
                                  self._mesh.devices.size), self._mesh)

        first_step = abs(start_itime) // abs(lsync)
        # re-derive the output window state for a mid-run resume (the
        # output AT start_itime, if due, happens inside the resumed body)
        while cmd.ldirect * loutend < cmd.ldirect * start_itime \
                and start_itime != 0:
            loutnext = loutnext + cmd.loutstep * cmd.ldirect
            loutstart = loutnext - loutaver // 2
            loutend = loutnext + loutaver // 2
        for istep in range(first_step, nsteps + 1):
            itime = istep * lsync
            if istep == first_step + 1:
                # the first step carries the compiles: mark where the
                # steady-state window begins
                self.timings["first_step_wall_s"] = (
                    _time.perf_counter() - t_wall0)
                self.timings["first_step_particle_steps"] = particle_steps
            if self.checkpoint_at is not None \
                    and itime == self.checkpoint_at \
                    and start_itime != itime:
                self.save_checkpoint(self.checkpoint_path, itime)
            z0, z1, mt0, mt1 = self._fields_for(itime)

            # interval since deposited-mass decay reference time
            # (wetdepo.f90:57-62)
            if cmd.ldirect * itime <= cmd.ldirect * loutnext:
                ldeltat = itime - (loutnext - cmd.loutstep * cmd.ldirect)
            else:
                ldeltat = itime - loutnext

            # wet deposition over the interval ending at itime
            # (timemanager.f90:164-169; field nearest itime-lsync/2)
            if self.any_wetdep and istep > 0:
                with self.timers.section("wetdepo",
                                         sync=lambda: self.particles):
                    interp_t = itime - lsync // 2
                    use0 = abs(mt0 - interp_t) < abs(mt1 - interp_t)
                    if self._tiles is not None:
                        zwt = self._get_tiles(mt0 if use0 else mt1)
                        lam, grfrac = self._tiled_wetscav(
                            self.particles, zwt, jnp.int32(itime),
                            jnp.int32(cmd.lsynctime))
                    else:
                        zw = z0 if use0 else z1
                        lam, grfrac = wetscav_all(
                            self.particles, zw, jnp.int32(itime),
                            jnp.int32(cmd.lsynctime), self.wet_species,
                            self.use_clwc)
                    self.particles, wdep = apply_wetdepo(
                        self.particles, lam, grfrac,
                        jnp.int32(cmd.lsynctime),
                        jnp.int32(ldeltat), self.mass_species)
                    if cmd.ldirect == 1:
                        self.acc = self.acc._replace(
                            wetgridunc=self._scatter_depo(
                                self.acc.wetgridunc, wdep, itime))

            # OH chemistry (timemanager.f90:171,216: gethourlyOH +
            # ohreaction)
            if self.any_ohreact and istep > 0:
                with self.timers.section("ohchem",
                                         sync=lambda: self.particles):
                    interp_t = itime - lsync // 2
                    zo = (z0 if abs(mt0 - interp_t) < abs(mt1 - interp_t)
                          else z1)
                    oh0, oh1, to0, to1 = self._hourly_oh.fields_for(itime)
                    temps = self._cell_temps(zo)
                    self.particles = self._ohreaction(
                        self.particles, oh0, oh1, jnp.int32(to0),
                        jnp.int32(to1), jnp.int32(itime), temps,
                        jnp.int32(cmd.lsynctime))

            # radioactive decay of deposited mass on the output grids
            # (timemanager.f90:269-304)
            if self.any_decay and istep > 0:
                wg, dg = decay_deposition_grids(
                    self.acc.wetgridunc, self.acc.drygridunc,
                    self._decay_arr, jnp.int32(cmd.lsynctime))
                self.acc = self.acc._replace(wetgridunc=wg, drygridunc=dg)

            # releases
            self.particles = activate(self.particles, jnp.int32(itime))

            # regional domain-fill boundary conditions
            # (timemanager.f90:244-251 -> boundcond_domainfill.f90)
            if self._boundary is not None:
                bkey = jax.random.fold_in(self._key, 3000000 + istep)
                if self._tiles is not None:
                    self.particles, self._boundary = \
                        self._tiled_boundcond(
                            self.particles, self._boundary,
                            self._get_tiles(mt0), self._get_tiles(mt1),
                            jnp.int32(itime), jnp.int32(mt0),
                            jnp.int32(mt1), bkey,
                            jnp.int32(cmd.lsynctime),
                            jnp.int32(min(cmd.itsplit, 499999999)),
                            jnp.float32(self.grid.ylat0),
                            jnp.float32(self.grid.dy))
                else:
                    from ..core.domainfill import boundcond_domainfill
                    xglobal_full = (self.grid.xglobal and float(
                        self._boundary.xlim[1]) == self.grid.nx - 2)
                    self.particles, self._boundary = boundcond_domainfill(
                        self.particles, self._boundary, z0, z1,
                        jnp.int32(itime), jnp.int32(mt0), jnp.int32(mt1),
                        bkey, jnp.int32(cmd.lsynctime),
                        jnp.int32(min(cmd.itsplit, 499999999)),
                        jnp.float32(self.grid.ylat0),
                        jnp.float32(self.grid.dy),
                        mdomainfill=cmd.mdomainfill, ldirect=cmd.ldirect,
                        nclassunc=self.nclassunc,
                        check_x=not xglobal_full)

            # backward-deposition scavenging factor for fresh particles
            # (timemanager.f90:565-598, once per particle after release)
            if self._bkdep_pending:
                from ..physics.bkdep import (assign_drybkdep,
                                             assign_wetbkdep)
                if self.bkdep == 4:
                    self._ensure_vdep_kernel(self._get_eta(mt1))
                    vd = z1.vdep
                    if vd is not None:
                        self.particles = assign_drybkdep(self.particles,
                                                         vd)
                else:
                    interp_t = itime + lsync // 2
                    zw = (z0 if abs(mt0 - interp_t) < abs(mt1 - interp_t)
                          else z1)
                    colh = jnp.full(self.particles.capacity, 20000.0)
                    self.particles = assign_wetbkdep(
                        self.particles, zw, jnp.int32(itime),
                        jnp.int32(cmd.lsynctime), self.wet_species,
                        self.use_clwc, colh)
                if int((self.particles.xscav[:, 0] < 0).sum()) == 0:
                    self._bkdep_pending = False

            # convective redistribution (timemanager.f90:258-263 ->
            # convmix/calcmatrix/convect/redist)
            if self.use_convection:
                t0c = _time.perf_counter()
                e0, e1 = self._get_eta(mt0), self._get_eta(mt1)
                dt1 = float(itime - mt0)
                dt2 = float(mt1 - itime)
                dtt = 1.0 / (dt1 + dt2)
                (fmassfrac, rlevmass, phconv, pconv, tconv, sub, uvzlev,
                 lconv, nctop, self.cbmf) = self.conv_kernel(
                    e0.ps, e0.tth, e0.qvh, e0.tt2, e0.td2,
                    e1.ps, e1.tth, e1.qvh, e1.tt2, e1.td2,
                    jnp.float32(dt2 * dtt), jnp.float32(dt1 * dtt),
                    self.cbmf, jnp.float32(abs(cmd.lsynctime)))
                ckey = jax.random.fold_in(self._key, 1000000 + istep)
                self.particles, n_moved = redist_particles(
                    self.particles, ckey, fmassfrac, rlevmass, phconv,
                    sub, uvzlev, pconv, tconv, lconv,
                    jnp.int32(cmd.lsynctime), jnp.int32(itime),
                    nl=self.conv_kernel.nl, nx=self.grid.nx,
                    ny=self.grid.ny, ldirect=cmd.ldirect)
                if self.profile:
                    jax.block_until_ready(self.particles)
                self.timers.add("convection", _time.perf_counter() - t0c)

            # quasilagrangian compressed dump at window centers
            # (timemanager.f90:368-369)
            ld = cmd.ldirect
            if (cmd.mquasilag == 1
                    and itime == (loutstart + loutend) // 2):
                from ..io.partdump import (particle_diagnostics,
                                           write_shortposit)
                from ..utils.dates import datestamp
                from pathlib import Path as _P
                dt1 = float(itime - mt0)
                dt2 = float(mt1 - itime)
                dtt = 1.0 / max(dt1 + dt2, 1e-9)
                dg = particle_diagnostics(self.particles, z0, z1,
                                          jnp.float32(dt2 * dtt),
                                          jnp.float32(dt1 * dtt))
                write_shortposit(
                    _P(self.outdir) / ("shortposit_" + datestamp(
                        add_seconds(cmd.bdate, itime))),
                    itime, self.particles, self.grid, dg[0])

            # sampling (timemanager.f90:350-365)
            if (ld * itime >= ld * loutstart and ld * itime <= ld * loutend
                    and (itime - loutstart) % loutsample == 0):
                weight = 0.5 if itime in (loutstart, loutend) else 1.0
                z1s = (self._get_tiles(mt1) if self._tiles is not None
                       else z1)
                with self.timers.section("conccalc",
                                         sync=lambda: self.acc):
                    self.acc = self.conccalc(
                        self.acc, self.particles, z1s, jnp.int32(itime),
                        self.lage, jnp.float32(weight),
                        self._ccfg_at(itime, self.conc_cfg))
                    if self.use_nested_output:
                        self.acc_n = self.conccalc_n(
                            self.acc_n, self.particles, z1s,
                            jnp.int32(itime), self.lage,
                            jnp.float32(weight),
                            self._ccfg_at(itime, self.conc_cfg_n))
                    if self.receptor_set is not None:
                        self.creceptor = sample_receptors(
                            self.creceptor, self.receptor_set,
                            self.particles, jnp.int32(itime),
                            jnp.float32(weight),
                            dx=self.grid.dx, dy=self.grid.dy)

            # output (timemanager.f90:376-464)
            if itime == loutend and self._outnum() > 0:
                with self.timers.section("output"):
                    self._write_output(itime)
                # particle dump cadence (timemanager.f90:453-455)
                if cmd.ipout == 1 and (abs(itime) // abs(cmd.loutstep)) \
                        % max(cmd.ipoutfac, 1) == 0:
                    self._write_partdump(itime, z0, z1, mt0, mt1)
                # time-averaged particle dump (ipout=3,
                # partoutput_average.f90)
                if cmd.ipout == 3 and self._avg_sums is not None:
                    from ..io.partdump import write_partposit_average
                    from ..utils.dates import datestamp
                    from pathlib import Path as _P
                    write_partposit_average(
                        _P(self.outdir) / ("partposit_average_"
                                           + datestamp(add_seconds(
                                               cmd.bdate, itime))),
                        itime, self.particles, self._avg_sums,
                        self._avg_counts)
                    self._avg_sums = None
                # particle splitting at output times once itime passes
                # itsplit (timemanager.f90:473-504)
                if cmd.itsplit < abs(ideltas) \
                        and abs(itime) >= cmd.itsplit:
                    if self._tiles is not None:
                        # tile-local slot allocation (children stay on
                        # the parent's tile)
                        self.particles = self._tiles.split(
                            self.particles, jnp.int32(itime))
                    else:
                        from ..core import split_particles
                        self.particles = split_particles(
                            self.particles, jnp.int32(itime), ldirect=ld)
                loutnext = loutnext + cmd.loutstep * ld
                loutstart = loutnext - loutaver // 2
                loutend = loutnext + loutaver // 2
                if itime == loutstart:
                    z1s = (self._get_tiles(mt1) if self._tiles is not None
                           else z1)
                    self.acc = self.conccalc(
                        self.acc, self.particles, z1s, jnp.int32(itime),
                        self.lage, jnp.float32(0.5),
                        self._ccfg_at(itime, self.conc_cfg))

            if itime == ideltas:
                break

            # advance
            t0 = _time.perf_counter()
            if self.use_initcond:
                prev_active = self.particles.active
            if self.use_flux:
                xold, yold, zold = (self.particles.x, self.particles.y,
                                    self.particles.z)
            key = jax.random.fold_in(self._key, istep)
            pre_state = None
            if self._tiles is not None:
                zt0, zt1 = self._get_tiles(mt0), self._get_tiles(mt1)
                adv_out = self._tiles.advance(
                    self.particles, zt0, zt1, jnp.int32(itime),
                    jnp.int32(mt0), jnp.int32(mt1), key, self.step_prm)
                if self._tiles.return_pre:
                    self.particles, n_act_d, n_unplaced, pre_state = \
                        adv_out
                else:
                    self.particles, n_act_d, n_unplaced = adv_out
                n_act = int(n_act_d)
                if int(n_unplaced):
                    # capacity escape valve: overflow particles stay in
                    # the halo and retry next step (domain.migrate_local)
                    log.warning("tile migration deferred %d particles "
                                "(hot tile near capacity %d)",
                                int(n_unplaced), self._tiles.local_cap)
                    self._tile_defer_streak += 1
                    if self._tile_defer_streak >= 2:
                        # persistent hot tile: dynamic rebalance at 2x
                        # capacity (mpif_calculate_part_redist analog)
                        new_cap = self._tiles.local_cap * 2
                        log.warning("tile rebalance: regrouping at "
                                    "local capacity %d", new_cap)
                        self.particles = self._tiles.regroup(
                            self.particles, new_cap)
                        self._tile_defer_streak = 0
                else:
                    self._tile_defer_streak = 0
            else:
                z0n = self._get_nest(mt0) if self.nest_grid else None
                z1n = self._get_nest(mt1) if self.nest_grid else None
                leg = (self._legacy_bases(itime) if self.legacy_rng
                       else None)
                self.particles, diag = advance_all(
                    self.particles, z0, z1, jnp.int32(itime),
                    jnp.int32(mt0), jnp.int32(mt1), key, self.step_cfg,
                    self.step_prm, z0n, z1n, leg=leg)
                n_act = int(diag.n_active)
                self.nan_count += int(getattr(diag, "nan_count", 0))
                self._t_below = diag.t_below    # adaptive drydep window
            particle_steps += n_act
            dt_adv = _time.perf_counter() - t0
            self.timers.add("advance", dt_adv)
            if "advance_first_s" not in self.timings:
                # dominated by the XLA compile of the advance program
                # (adaptive/CBL configs compile slowest)
                self.timings["advance_first_s"] = round(dt_adv, 2)
            if self.use_initcond and pre_state is not None:
                # post-migration baseline for the drydep/age death scan
                prev_active2 = self.particles.active

            # per-step averaged-property accumulation (ipout=3,
            # partpos_average.f90 analog, timemanager.f90:617)
            if cmd.ipout == 3:
                from ..io.partdump import averaging_sample
                dt1 = float(itime + lsync - mt0)
                dt2 = float(mt1 - itime - lsync)
                dtt = 1.0 / max(dt1 + dt2, 1e-9)
                sample, live = averaging_sample(
                    self.particles, z0, z1, jnp.float32(dt2 * dtt),
                    jnp.float32(dt1 * dtt), self.grid.dx, self.grid.dy,
                    self.grid.xlon0, self.grid.ylat0)
                inc = jnp.where(live, 1.0, 0.0)
                contrib = sample * inc[None, :]
                if self._avg_sums is None:
                    self._avg_sums = contrib
                    self._avg_counts = inc
                else:
                    self._avg_sums = self._avg_sums + contrib
                    self._avg_counts = self._avg_counts + inc

            # gross fluxes across output faces (timemanager.f90:617-623).
            # Tiles mode: slots shuffle during migration, so the
            # old/new pairing uses the PRE-migration state (same slots
            # as the xold snapshot); replicated flux grid + sharded
            # particles reduce under GSPMD.
            if self.use_flux:
                p_flux = pre_state if pre_state is not None \
                    else self.particles
                itage = jnp.abs(jnp.int32(itime + lsync)
                                - p_flux.itramem)
                nage_idx = jnp.clip(
                    jnp.searchsorted(self.lage, itage, side="right"),
                    0, self.conc_cfg.nage - 1)
                kp = (p_flux.npoint if cmd.ioutputforeachrelease
                      else jnp.zeros_like(p_flux.npoint))
                self.flux = self._calcfluxes(
                    self.flux, p_flux, xold, yold, zold,
                    nage_idx, kp, jnp.int32(itime + lsync), self.flux_cfg)

            # decay + dry deposition + minmass (timemanager.f90:643-686)
            if self.any_drydep or self.any_decay:
                with self.timers.section("drydepo",
                                         sync=lambda: self.particles):
                    if self._tiles is not None:
                        self.particles, ddep = self._tiled_drydep(
                            self.particles, self._get_tiles(mt1),
                            jnp.int32(cmd.lsynctime), jnp.int32(ldeltat))
                    else:
                        vdep = z1.vdep if self.any_drydep else None
                        self.particles, ddep = apply_decay_drydep(
                            self.particles, vdep, jnp.int32(cmd.lsynctime),
                            jnp.int32(ldeltat), self.mass_species,
                            has_vdep=self.any_drydep,
                            t_below=getattr(self, "_t_below", None))
                    if self.any_drydep and cmd.ldirect == 1:
                        self.acc = self.acc._replace(
                            drygridunc=self._scatter_depo(
                                self.acc.drygridunc, ddep, itime + lsync))

            # age-class termination (timemanager.f90:701-707)
            max_age = self.ageclasses.max_age
            if max_age is not None:
                age = jnp.abs(jnp.int32(itime + lsync)
                              - self.particles.itramem)
                self.particles = self.particles._replace(
                    active=self.particles.active & (age <= max_age))

            # initial-condition sensitivity for terminated particles
            # (timemanager.f90:631,702).  Tiles mode scatters in two
            # phases around the slot shuffle: advance/domain-exit
            # deaths against the pre-migration state, drydep/age
            # deaths against the stable post-migration slots.
            if self.use_initcond:
                if pre_state is not None:
                    died_adv = prev_active & ~pre_state.active
                    self.init_cond = self._ic_scatter(
                        self.init_cond, pre_state, died_adv, z1,
                        self.ic_cfg)
                    died = prev_active2 & ~self.particles.active
                else:
                    died = prev_active & ~self.particles.active
                self.init_cond = self._ic_scatter(
                    self.init_cond, self.particles, died, z1, self.ic_cfg)

            if progress and istep % 10 == 0:
                log.info("t=%8d s  particles=%8d", itime, n_act)

        # run end: survivors contribute too, then dump grid_initial_*
        # (timemanager.f90:735-747)
        if self.use_initcond:
            z0e, z1e, _, _ = self._fields_for(itime)
            self.init_cond = self._ic_scatter(
                self.init_cond, self.particles, self.particles.active,
                z1e, self.ic_cfg)
            from ..grid.initcond import write_initial_cond
            write_initial_cond(self.outdir, itime, self.init_cond,
                               self._release_mass)

        if cmd.ipout in (1, 2):
            z0, z1, mt0, mt1 = self._fields_for(itime)
            self._write_partdump(itime, z0, z1, mt0, mt1, end=True)
        self.last_itime = itime
        self.timings.update(self.timers.seconds)
        self.timings["wall"] = _time.perf_counter() - t_wall0
        self.timings["particle_steps"] = particle_steps
        if self.nan_count > 0:
            # the reference warns when the CBL scheme redraws NaNs
            # (timemanager.f90:714-727 nan_count reporting)
            log.warning("CBL scheme redrew %d NaN velocities; reduce "
                        "ifine if this is a non-negligible fraction of "
                        "the particle count", self.nan_count)
        if self.profile:
            report = self.timers.report(extra={
                "psteps/s": f"{particle_steps / max(self.timings['wall'], 1e-9):.0f}",
                "nan_count": self.nan_count,
                "prefetch_failures": self._prefetch_failures,
                "advance_first_s(compile)": self.timings.get(
                    "advance_first_s", 0.0)})
            log.info("per-section timings (device-synced):\n%s", report)
            (Path(self.outdir) / "profile.txt").write_text(report + "\n")
        return self.particles

    def _write_fortran_header(self):
        """Reference-format 'header' file (writeheader.f90)."""
        from pathlib import Path as _P
        from ..io.fortran_writer import write_header
        cmd = self.cmd
        rels = []
        for b in self.releases.boxes:
            rt1 = int((b.start - cmd.bdate).total_seconds())
            rt2 = int((b.end - cmd.bdate).total_seconds())
            if cmd.ldirect < 0:
                rt1, rt2 = -rt2, -rt1
            rels.append(dict(
                start=rt1, end=rt2, kindz=b.zkind,
                xp1=b.lon1, yp1=b.lat1, xp2=b.lon2, yp2=b.lat2,
                zp1=b.z1, zp2=b.z2, npart=b.parts, comment=b.comment,
                xmass=list(b.mass) + [0.0] * (self.nspec - len(b.mass))))
        _P(self.outdir).mkdir(parents=True, exist_ok=True)
        write_header(
            _P(self.outdir) / "header",
            ibdate=cmd.ibdate if cmd.ldirect == 1 else cmd.iedate,
            ibtime=cmd.ibtime if cmd.ldirect == 1 else cmd.ietime,
            loutstep=cmd.loutstep, loutaver=cmd.loutaver,
            loutsample=cmd.loutsample,
            outlon0=self.outgrid.outlon0, outlat0=self.outgrid.outlat0,
            numxgrid=self.geo.nxg, numygrid=self.geo.nyg,
            dxout=self.outgrid.dxout, dyout=self.outgrid.dyout,
            outheights=self.outgrid.outheights,
            jjjjmmdd=cmd.bdate.year * 10000 + cmd.bdate.month * 100
            + cmd.bdate.day,
            ihmmss=cmd.bdate.hour * 10000 + cmd.bdate.minute * 100
            + cmd.bdate.second,
            species_names=[s.name for s in self.releases.species],
            maxpointspec_act=self.conc_cfg.npointspec,
            releases=rels, method=cmd.method, lsubgrid=cmd.lsubgrid,
            lconvection=cmd.lconvection, ind_source=cmd.ind_source,
            ind_receptor=cmd.ind_receptor,
            nageclass=self.ageclasses.nageclass,
            lage=self.ageclasses.lage or (999999999,))

    def _write_fortran_grids(self, when, conc, wet, dry, rho_out=None):
        """grid_conc_* / grid_time_* sparse files (concoutput.f90) plus
        the grid_pptv_* mixing-ratio variant for iout=2/3
        (concoutput.f90:460-600 unitoutgridppt)."""
        from pathlib import Path as _P
        from ..io.fortran_writer import write_grid_sparse
        from ..utils.dates import datestamp
        stem = "grid_conc_" if self.cmd.ldirect == 1 else "grid_time_"
        pfac = self.writer.pptv_factor(rho_out, self.nspec)
        for ks in range(self.nspec):
            if self.cmd.iout_eff in (1, 3, 5):
                path = _P(self.outdir) / (stem + datestamp(when)
                                          + f"_{ks + 1:03d}")
                write_grid_sparse(
                    path, int(self._fort_itime), conc[ks],
                    wet[ks] if wet is not None else None,
                    dry[ks] if dry is not None else None)
            if self.cmd.iout_eff in (2, 3):
                path = _P(self.outdir) / ("grid_pptv_" + datestamp(when)
                                          + f"_{ks + 1:03d}")
                pk = conc[ks] * pfac[ks][None, None] \
                    if pfac is not None else conc[ks]
                write_grid_sparse(
                    path, int(self._fort_itime), pk,
                    wet[ks] if wet is not None else None,
                    dry[ks] if dry is not None else None)

    def _write_fortran_inversion(self, when, conc):
        """Inversion time series (concoutput_inversion.f90:295-545): one
        file per (release point, species) named by the RELEASE date,
        appended each output step with (jjjjmmdd, ihmmss) records and the
        surface-layer sparse concentration block (surf_only rule)."""
        import struct as _struct
        from pathlib import Path as _P
        from ..io.fortran_writer import _rec, _sparse_block
        from ..utils.dates import datestamp
        cmd = self.cmd
        stem = "grid_conc_" if cmd.ldirect == 1 else "grid_time_"
        nx, ny = self.geo.nxg, self.geo.nyg
        jjjjmmdd = when.year * 10000 + when.month * 100 + when.day
        ihmmss = when.hour * 10000 + when.minute * 100 + when.second
        for ks in range(self.nspec):
            for kp in range(self.conc_cfg.npointspec):
                box = self.releases.boxes[min(kp,
                                              self.numpoint - 1)]
                reldate = datestamp(box.start)
                path = _P(self.outdir) / (stem + reldate
                                          + f"_{ks + 1:03d}")
                out = (_rec(_struct.pack("<i", jjjjmmdd))
                       + _rec(_struct.pack("<i", ihmmss)))
                for na in range(self.conc_cfg.nage):
                    out += _sparse_block(conc[ks, kp, na, 0].ravel(),
                                         index_offset=nx * ny)
                mode = "ab" if path.exists() else "wb"
                with open(path, mode) as f:
                    f.write(out)

    def _write_partdump(self, itime, z0, z1, mt0, mt1, end=False):
        from ..io.partdump import particle_diagnostics, write_partposit
        from ..utils.dates import datestamp
        dt1 = float(itime - mt0)
        dt2 = float(mt1 - itime)
        dtt = 1.0 / max(dt1 + dt2, 1e-9)
        diag = particle_diagnostics(self.particles, z0, z1,
                                    jnp.float32(dt2 * dtt),
                                    jnp.float32(dt1 * dtt))
        from pathlib import Path
        name = ("partposit_end" if end else
                "partposit_" + datestamp(add_seconds(self.cmd.bdate, itime)))
        write_partposit(Path(self.outdir) / name, itime, self.particles,
                        self.grid, diag, only_current=not end)

    def save_checkpoint(self, path, itime=None):
        from ..io.partdump import save_checkpoint
        save_checkpoint(path, self, itime if itime is not None
                        else getattr(self, "last_itime", 0))

    def load_checkpoint(self, path) -> int:
        from ..io.partdump import load_checkpoint
        return load_checkpoint(path, self)

    def _legacy_release_positions(self):
        """Replace the scheduled release draws with the reference's
        exact ran1 consumption order (releaseparticles.f90:147-193):
        per particle x, y, nclass, z from ONE shared idummy chain
        across all boxes."""
        from ..validation.depo_oracle import legacy_release
        from ..validation.legacy_rng import Ran1
        p = self.particles
        ran1 = Ran1(self.legacy_seed)
        xs, ys, ncl, zs = [], [], [], []
        for b in self.releases.boxes:
            bx = dict(lon1=b.lon1, lon2=b.lon2, lat1=b.lat1,
                      lat2=b.lat2, z1=b.z1, z2=b.z2)
            x, y, nc, z = legacy_release(
                bx, b.parts, self.nclassunc, self.grid.xlon0,
                self.grid.ylat0, self.grid.dx, self.grid.dy, ran1=ran1)
            xs.append(x)
            ys.append(y)
            ncl.append(nc)
            zs.append(z)
        x = np.concatenate(xs)
        idx = np.arange(len(x))
        self.particles = p._replace(
            x_hi=p.x_hi.at[idx].set(jnp.asarray(x, jnp.float32)),
            y_hi=p.y_hi.at[idx].set(
                jnp.asarray(np.concatenate(ys), jnp.float32)),
            z=p.z.at[idx].set(
                jnp.asarray(np.concatenate(zs), jnp.float32)),
            nclass=p.nclass.at[idx].set(
                jnp.asarray(np.concatenate(ncl), jnp.int32)))

    def _legacy_bases(self, itime: int):
        """Per-particle nrand bases for this step, consumed from the
        shared host-side ran3 chain in reference order: per particle in
        slot order, the initialize draw (fresh particles only) then the
        advance draw (timemanager.f90:553-611)."""
        from ..core.advance import LegacyRnd
        stream = self._legacy_stream
        active = np.asarray(self.particles.active)
        itramem = np.asarray(self.particles.itramem)
        n = active.shape[0]
        ni = np.ones(n, np.int64)
        na = np.ones(n, np.int64)
        fresh = (itramem == itime) | (itime == 0)
        for j in np.nonzero(active)[0]:
            if fresh[j]:
                ni[j] = stream.next_nrand()
            na[j] = stream.next_nrand()
        if self.legacy_trace:
            if not hasattr(self, "_legacy_trace"):
                self._legacy_trace = []
            self._legacy_trace.append(dict(
                itime=int(itime), ni=ni.copy(), na=na.copy(),
                x=np.asarray(self.particles.x, np.float64),
                y=np.asarray(self.particles.y, np.float64),
                z=np.asarray(self.particles.z, np.float32),
                mass=np.asarray(self.particles.mass, np.float32),
                active=active.copy(),
                idt=np.asarray(self.particles.idt, np.int32)))
        return LegacyRnd(table=self._legacy_table,
                         nrand_init=jnp.asarray(ni, jnp.int32),
                         nrand=jnp.asarray(na, jnp.int32))

    def _cell_temps(self, zf):
        """Cell-center temperature at each particle (ohreaction.f90:139)."""
        from ..met.fields import F3_TT
        from ..core.interp import vert_weights
        p = self.particles
        ix = jnp.clip(p.x.astype(jnp.int32), 0, self.grid.nx - 1)
        jy = jnp.clip(p.y.astype(jnp.int32), 0, self.grid.ny - 1)
        indz, _ = vert_weights(p.z, zf.height)
        return zf.f3d[F3_TT][indz, jy, ix]

    def _scatter_depo(self, grid, deposit, itime):
        """Kernel scatter of per-particle deposits (wet/drydepokernel)."""
        p = self.particles
        itage = jnp.abs(jnp.int32(itime) - p.itramem)
        nage_idx = jnp.clip(jnp.searchsorted(self.lage, itage,
                                             side="right"),
                            0, self.conc_cfg.nage - 1)
        kp = (p.npoint if self.cmd.ioutputforeachrelease
              else jnp.zeros_like(p.npoint))
        return self.depo_scatter(grid, deposit, p, nage_idx, kp)

    # ----- output (concoutput.f90 analog) -----
    def _outnum(self) -> float:
        """Global sample count (partials carry it per device)."""
        o = np.asarray(jax.device_get(self.acc.outnum))
        return float(o if o.ndim == 0 else o.mean())

    def _write_output(self, itime: int):
        if self._mesh is not None:
            from ..parallel import reduce_acc_partials
            acc = jax.device_get(reduce_acc_partials(self.acc))
        else:
            acc = jax.device_get(self.acc)
        outnum = float(acc.outnum)
        g = np.asarray(acc.gridunc)  # (nage,nclass,kp,nz,ny,nx,ks)
        # sum over uncertainty classes = total; std over classes = uncertainty
        total = g.sum(axis=1)
        if g.shape[1] > 1:
            unc = g.std(axis=1, ddof=1) * g.shape[1]
        else:
            unc = np.zeros_like(total)
        vol = self.geo.volume  # (nz,ny,nx)
        if self.cmd.ldirect == 1:
            factor = 1.0e12 / vol / outnum
        else:
            factor = np.full_like(vol, abs(self.cmd.loutaver) / outnum)
        conc = total * factor[None, None, :, :, :, None]
        unc = unc * factor[None, None, :, :, :, None]
        # reorder to (nspec, npoint, nage, nz, ny, nx)
        conc = np.moveaxis(conc, -1, 0).transpose(0, 2, 1, 3, 4, 5)
        unc = np.moveaxis(unc, -1, 0).transpose(0, 2, 1, 3, 4, 5)

        # cumulative wet/dry deposition in 1e-12 kg/m2
        # (concoutput.f90 wetgrid: factor 1e12/area, no outnum division)
        wet = dry = None
        if self.any_wetdep or self.any_drydep:
            area = self.geo.area
            afac = np.where(area > 0.0, 1.0e12 / np.maximum(area, 1e-30),
                            0.0)                   # (ny, nx)

            def dep2out(g):  # (nage,nclass,kp,ny,nx,ks) -> (ks,kp,nage,...)
                d = np.asarray(g).sum(axis=1)       # over nclass
                d = np.moveaxis(d, -1, 0).transpose(0, 2, 1, 3, 4)
                return d * afac[None, None, None]

            wet = dep2out(acc.wetgridunc)
            dry = dep2out(acc.drygridunc)

        when = add_seconds(self.cmd.bdate, itime)
        # air density at output layers for the pptv conversion
        # (concoutput.f90:156-196; newest time level = memind(2))
        rho_out = None
        if self.cmd.iout_eff in (2, 3) or self.receptor_set is not None:
            from ..met.fields import F3_RHO
            from ..grid.outgrid import density_outgrid
            _, z1o, _, _ = self._fields_for(itime)
            self._rho_met = np.asarray(jax.device_get(z1o.f3d[F3_RHO]))
            rho_out = density_outgrid(self.geo, np.asarray(z1o.height),
                                      self._rho_met)
        self.writer.write(when, conc, unc, wet=wet, dry=dry,
                          rho_out=rho_out)
        if self.write_fortran:
            self._fort_itime = itime
            if self.cmd.linversionout == 1:
                self._write_fortran_inversion(when, conc)
            else:
                self._write_fortran_grids(when, conc, wet, dry,
                                          rho_out=rho_out)
        if self.use_nested_output:
            if self._mesh is not None:
                from ..parallel import reduce_acc_partials
                accn = jax.device_get(reduce_acc_partials(self.acc_n))
            else:
                accn = jax.device_get(self.acc_n)
            gn = np.asarray(accn.gridunc)
            tn = gn.sum(axis=1)
            voln = self.geo_n.volume
            if self.cmd.ldirect == 1:
                fac_n = 1.0e12 / voln / outnum
            else:
                fac_n = np.full_like(voln, abs(self.cmd.loutaver) / outnum)
            concn = tn * fac_n[None, None, :, :, :, None]
            concn = np.moveaxis(concn, -1, 0).transpose(0, 2, 1, 3, 4, 5)
            self.writer_n.write(when, concn, np.zeros_like(concn))
            if self._mesh is not None:
                self.acc_n = jax.tree.map(jnp.zeros_like, self.acc_n)
            else:
                self.acc_n = zero_accumulators(
                    self.geo_n, self.nspec, self.conc_cfg.npointspec,
                    self.nclassunc, self.ageclasses.nageclass)
        from ..utils.dates import datestamp
        from pathlib import Path as _P
        if self.receptor_set is not None:
            # receptor concentrations in output units (ng/m3 analog):
            # 1e12 * mean over samples (concoutput.f90:670-676)
            rc = np.asarray(self.creceptor) * 1.0e12 / outnum
            np.savez(_P(self.outdir) / f"receptor_conc_{datestamp(when)}"
                     ".npz",
                     conc=rc, names=np.asarray(self.receptor_names))
            # reference unformatted receptor_conc (openreceptors.f90 +
            # concoutput.f90:672-676), appended per output time
            from ..io.fortran_writer import (append_receptor,
                                             write_receptor_header)
            rpath = _P(self.outdir) / "receptor_conc"
            rs = self.receptor_set
            lons = (np.asarray(rs.x) * self.grid.dx + self.grid.xlon0)
            lats = (np.asarray(rs.y) * self.grid.dy + self.grid.ylat0)
            if not rpath.exists():
                write_receptor_header(rpath, self.receptor_names,
                                      lons, lats)
            append_receptor(rpath, itime, rc)
            # mixing-ratio receptor dump (receptor_pptv,
            # openreceptors.f90:54-58 + concoutput.f90:662-667:
            # x weightair/weightmolar(ks)/densityoutrecept)
            if self.cmd.iout_eff in (2, 3):
                from ..grid.outgrid import density_receptors
                rhor = density_receptors(rs.x, rs.y, self._rho_met)
                wm = np.asarray([s.weightmolar
                                 for s in self.releases.species],
                                np.float32)
                wfac = np.where(wm > 0, 28.97 / np.maximum(wm, 1e-30),
                                1.0)
                rppt = rc * wfac[None, :] / np.maximum(rhor, 1e-30)[:, None]
                ppath = _P(self.outdir) / "receptor_pptv"
                if not ppath.exists():
                    write_receptor_header(ppath, self.receptor_names,
                                          lons, lats)
                append_receptor(ppath, itime, rppt)
            self.creceptor = jnp.zeros_like(self.creceptor)
        if self.use_flux:
            # grid_flux output (fluxoutput.f90): per-face ng/m2/s in the
            # reference's unformatted layout + raw npz
            np.savez_compressed(
                _P(self.outdir) / f"grid_flux_{datestamp(when)}.npz",
                flux=np.asarray(self.flux))
            from ..io.fortran_writer import write_flux
            write_flux(_P(self.outdir) / f"grid_flux_{datestamp(when)}",
                       itime, np.asarray(self.flux), self.geo.areaeast,
                       self.geo.areanorth, self.geo.area,
                       abs(self.cmd.loutstep))
            # reset per output interval (fluxoutput.f90:287-300)
            self.flux = jnp.zeros_like(self.flux)
        if self.use_plumetraj:
            z0, z1, mt0, mt1 = self._fields_for(itime)
            from ..io.partdump import particle_diagnostics
            dt1 = float(itime - mt0)
            dt2 = float(mt1 - itime)
            dtt = 1.0 / max(dt1 + dt2, 1e-9)
            diag = particle_diagnostics(self.particles, z0, z1,
                                        jnp.float32(dt2 * dtt),
                                        jnp.float32(dt1 * dtt))
            from ..grid.plumetraj import plume_step
            plume_step(self.particles, self.grid, diag, itime,
                       self.numpoint, self._plume_writer)
        # concentrations reset each output window; deposition grids are
        # CUMULATIVE over the run (concoutput.f90 never zeroes wetgridunc)
        if self._mesh is not None:
            # zero the concentration partials, keep cumulative wet/dry
            self.acc = self.acc._replace(
                gridunc=jnp.zeros_like(self.acc.gridunc),
                outnum=jnp.zeros_like(self.acc.outnum))
        else:
            zeroed = zero_accumulators(
                self.geo, self.nspec, self.conc_cfg.npointspec,
                self.nclassunc, self.ageclasses.nageclass)
            self.acc = zeroed._replace(wetgridunc=self.acc.wetgridunc,
                                       drygridunc=self.acc.drygridunc)
        log.info("output written at %s (outnum=%.1f)", when, outnum)
