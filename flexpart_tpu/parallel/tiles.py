"""Domain-decomposed production engine (`Simulation(distributed="tiles")`).

The met-field memory axis: each device holds one haloed lat/lon tile of
the processed field stack (parallel/domain.py) instead of a full replica,
and the per-step physics that samples met fields at particle positions
runs tile-locally under one ("ty","tx") shard_map per phase:

  * advance + BCs + ppermute migration  (domain.make_tiled_advance —
    the timemanager_mpi.f90:211-858 particle loop on tiles),
  * wet-scavenging coefficients         (wetdepo.f90/get_wetscav.f90),
  * decay + dry deposition              (timemanager.f90:643-686),
  * concentration sampling              (conccalc.f90) and wet/dry
    deposit scatters (wet/drydepokernel.f90) into per-device partial
    accumulators with a leading device axis, reduced only at output
    time (`reduce_acc_partials`, the mpif_tm_reduce_grid analog).

Particles carry GLOBAL mother-grid positions between phases; each
shard_map body shifts them into its tile's haloed local frame before any
field gather (the post-migration invariant is that every active particle
sits inside its owning tile's interior, so local bilinear stencils never
leave the halo).

Capacity escape valve: `plan_tile_capacity` sizes the per-tile buffer
from the actual release assignment (hot tiles get the head-room the
reference gets from `mp_maxpart_factor`, mpi_mod.f90:323) and migration
overflow degrades to retry-next-step via the halo slack rather than
particle loss (domain.migrate_local), with the overflow count surfaced
per step.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.advance import StepConfig
from ..core.state import Particles
from ..grid.conccalc import ConcConfig, _conccalc_impl
from ..grid.outgrid import Accumulators, OutputGridGeometry
from ..met.fields import ZFields
from ..physics.massupdate import apply_decay_drydep
from ..physics.wetdepo import wetscav_all
from .domain import (AX_TX, AX_TY, decompose_zfields, halo_for,
                     make_tiled_advance)


def choose_tile_mesh(n_devices: int, ny: int, nx_field: int):
    """Pick (nty, ntx) with nty*ntx == n_devices, preferring
    factorizations that divide the met grid exactly and, among those,
    an aspect ratio matching the grid's.  When no factorization
    divides (standard ECMWF 361x181-row grids on an 8-device mesh),
    fall back to CEIL-sized tiles with minimal
    padding: the pad rows/cols are pole-clamped / seam-wrapped by
    `_tile_indices` and no particle ever enters them (positions stay
    < ny-1 / wrap at the true cyclic width), so the physics is
    unchanged — only a few duplicated field columns ride along."""
    best = None
    for nty in range(1, n_devices + 1):
        if n_devices % nty:
            continue
        ntx = n_devices // nty
        ty = -(-ny // nty)
        tx = -(-nx_field // ntx)
        if ty < 2 or tx < 2:
            continue
        pad = (ty * nty - ny) * nx_field + (tx * ntx - nx_field) * ny
        aspect = abs(np.log(max(ntx, 1) / max(nty, 1))
                     - np.log(nx_field / ny))
        # combined score: a grid-matched aspect ratio (less halo area,
        # better seam balance) is worth a few duplicated pad rows —
        # 360x181 over 8 devices picks 2x4 with one pad row, not 1x8
        score = aspect + 5.0 * pad / (ny * nx_field)
        if best is None or score < best[0]:
            best = (score, nty, ntx)
    if best is None:
        raise ValueError(
            f"{n_devices} devices cannot tile the {ny}x{nx_field} met "
            "grid (tiles would be under 2 cells); change the device "
            "count")
    return best[1], best[2]


def tile_mesh(nty: int, ntx: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    devs = np.asarray(devices[:nty * ntx]).reshape(nty, ntx)
    return Mesh(devs, (AX_TY, AX_TX))


def plan_tile_capacity(x, y, active, ntx: int, nty: int, tx: int, ty: int,
                      slack: float = 1.5, floor: int = 64) -> int:
    """Per-tile slot count from the actual initial assignment (all
    schedulable slots, released-or-not): hot tiles (localized releases)
    get `slack` head-room for migration churn — the capacity escape
    valve (vs the previous shard_by_tile hard failure; the reference's
    analog is mp_maxpart_factor, mpi_mod.f90:323)."""
    it = np.clip((np.asarray(x) // tx).astype(int), 0, ntx - 1)
    jt = np.clip((np.asarray(y) // ty).astype(int), 0, nty - 1)
    occ = np.bincount(jt * ntx + it, minlength=ntx * nty)
    need = int(np.ceil(occ.max() * slack)) + floor
    return -(-need // 8) * 8                        # round up to 8


class _ZSpecs:
    """PartitionSpec tree for a tiled ZFields (leading device axis)."""

    @staticmethod
    def make(has_vdep: bool) -> ZFields:
        t = P((AX_TY, AX_TX))
        return ZFields(f3d=t, f2d=t, clouds=t,
                       vdep=t if has_vdep else None, height=P())


def _local_zfields(zt: ZFields) -> ZFields:
    """Strip the per-device leading tile axis inside shard_map."""
    return ZFields(f3d=zt.f3d[0], f2d=zt.f2d[0], clouds=zt.clouds[0],
                   vdep=None if zt.vdep is None else zt.vdep[0],
                   height=zt.height)


def _origins(tx: int, ty: int, halo: int):
    it = lax.axis_index(AX_TX)
    jt = lax.axis_index(AX_TY)
    x0 = (it * tx - halo).astype(jnp.float32)
    y0 = (jt * ty - halo).astype(jnp.float32)
    return x0, y0


def _to_local(p: Particles, x0, y0) -> Particles:
    return p._replace(x_hi=p.x_hi - x0, y_hi=p.y_hi - y0)


P_PART = None  # filled below


def _particle_specs():
    return Particles(*[P((AX_TY, AX_TX))] * len(Particles._fields))


def zero_tile_acc_partials(mesh: Mesh, geo: OutputGridGeometry, nspec: int,
                           npointspec: int, nclassunc: int = 1,
                           nage: int = 1) -> Accumulators:
    """Per-device full-output-grid partials, leading axis split over the
    2-D tile mesh (the unc_mod `*0` analog; output grids stay global
    because particles anywhere may sample any output cell)."""
    ndev = mesh.devices.size
    sh = NamedSharding(mesh, P((AX_TY, AX_TX)))
    shape3 = (ndev, nage, nclassunc, npointspec,
              geo.nzg, geo.nyg, geo.nxg, nspec)
    shape2 = (ndev, nage, nclassunc, npointspec, geo.nyg, geo.nxg, nspec)
    return Accumulators(
        gridunc=jax.device_put(jnp.zeros(shape3, jnp.float32), sh),
        wetgridunc=jax.device_put(jnp.zeros(shape2, jnp.float32), sh),
        drygridunc=jax.device_put(jnp.zeros(shape2, jnp.float32), sh),
        outnum=jax.device_put(jnp.zeros((ndev,), jnp.float32), sh),
    )


def make_tiled_conccalc(mesh: Mesh, outheights, cfg: ConcConfig,
                        tx: int, ty: int, halo: int, has_vdep: bool):
    """conccalc into per-device partials; the ind_samp=-1 density gather
    is tile-local, the output-grid mapping global (conccalc.f90)."""
    oh = jnp.asarray(np.asarray(outheights, np.float32))
    p_specs = _particle_specs()
    a_specs = Accumulators(*[P((AX_TY, AX_TX))] * len(Accumulators._fields))
    z_specs = _ZSpecs.make(has_vdep)

    def _local(acc, p, zt, itime, lage, weight):
        x0, y0 = _origins(tx, ty, halo)
        zf = _local_zfields(zt)
        acc_in = Accumulators(gridunc=acc.gridunc[0],
                              wetgridunc=acc.wetgridunc[0],
                              drygridunc=acc.drygridunc[0],
                              outnum=acc.outnum[0])
        out = _conccalc_impl(acc_in, p, zf, itime, lage, weight, cfg, oh,
                             origin=(x0, y0))
        return Accumulators(gridunc=out.gridunc[None],
                            wetgridunc=out.wetgridunc[None],
                            drygridunc=out.drygridunc[None],
                            outnum=out.outnum[None])

    fn = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(a_specs, p_specs, z_specs, P(), P(), P()),
        out_specs=a_specs)
    return jax.jit(fn)


def make_tiled_wetscav(mesh: Mesh, species: tuple, use_clwc: bool,
                       tx: int, ty: int, halo: int, has_vdep: bool):
    """Tile-local wet-scavenging coefficients (get_wetscav.f90): shift
    particle positions into the tile frame, sample the haloed tile."""
    p_specs = _particle_specs()
    z_specs = _ZSpecs.make(has_vdep)

    def _local(p, zt, itime, ltsample):
        x0, y0 = _origins(tx, ty, halo)
        zf = _local_zfields(zt)
        lam, grfrac = wetscav_all(_to_local(p, x0, y0), zf, itime,
                                  ltsample, species, use_clwc)
        return lam, grfrac

    fn = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(p_specs, z_specs, P(), P()),
        out_specs=(P(None, (AX_TY, AX_TX)), P((AX_TY, AX_TX))))
    return jax.jit(fn)


def make_tiled_decay_drydep(mesh: Mesh, sp, has_vdep: bool,
                            tx: int, ty: int, halo: int,
                            z_has_vdep: bool):
    """Decay + dry-deposition mass update with the deposition-velocity
    field sampled from the local tile (timemanager.f90:643-686)."""
    p_specs = _particle_specs()
    z_specs = _ZSpecs.make(z_has_vdep)

    def _local(p, zt, lsynctime, ldeltat):
        x0, y0 = _origins(tx, ty, halo)
        zf = _local_zfields(zt)
        pl = _to_local(p, x0, y0)
        pl2, dep = apply_decay_drydep(pl, zf.vdep, lsynctime, ldeltat,
                                      sp, has_vdep)
        return p._replace(mass=pl2.mass, active=pl2.active), dep

    fn = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(p_specs, z_specs, P(), P()),
        out_specs=(p_specs, P(None, (AX_TY, AX_TX))))
    return jax.jit(fn)


def make_tiled_split(mesh: Mesh, ldirect: int):
    """Particle splitting with TILE-LOCAL free-slot allocation
    (timemanager.f90:473-504).  The serial split's prefix-sum slot
    allocator runs per device inside shard_map, so each child lands in
    a slot of its parent's OWN tile buffer — the child inherits the
    parent's position, keeping the post-migration invariant (every
    active particle inside its owning tile) without communication.
    The reference MPI build splits rank-locally the same way
    (each rank's own particle arrays)."""
    from ..core import split_particles
    p_specs = _particle_specs()

    def _local(p, itime):
        return split_particles(p, itime, ldirect=ldirect)

    fn = jax.shard_map(_local, mesh=mesh, in_specs=(p_specs, P()),
                       out_specs=p_specs)
    return jax.jit(fn)


def make_tiled_depo_scatter(mesh: Mesh, scatter_fn):
    """wet/drydepokernel scatter into per-device partial 2-D grids on the
    2-D tile mesh (positions are global, so the plain scatter applies)."""
    p_specs = _particle_specs()
    t = P((AX_TY, AX_TX))

    def _local(grid, deposit, p, nage_idx, kp):
        return scatter_fn(grid[0], deposit, p, nage_idx, kp)[None]

    fn = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(t, P(None, (AX_TY, AX_TX)), p_specs, t, t),
        out_specs=t)
    return jax.jit(fn)


class TiledEngine:
    """Everything the Simulation needs to run distributed="tiles"."""

    def __init__(self, mesh: Mesh, cfg: StepConfig, grid,
                 nty: int, ntx: int, halo: int, msg_cap: int = 4096,
                 return_pre: bool = False):
        self.mesh = mesh
        self.nty, self.ntx = nty, ntx
        self.halo = halo
        self.nx_field = grid.nxfield
        self.xglobal = grid.xglobal
        # ceil tile sizes: non-dividing grids get pole-clamped /
        # seam-wrapped pad rows/cols no particle ever reaches
        self.tx = -(-self.nx_field // ntx)
        self.ty = -(-grid.ny // nty)
        self.msg_cap = msg_cap
        self.return_pre = return_pre
        self.sharding = NamedSharding(mesh, P((AX_TY, AX_TX)))
        self.advance = make_tiled_advance(mesh, cfg, ntx, nty,
                                          self.tx, self.ty, halo,
                                          msg_cap=msg_cap,
                                          return_pre=return_pre)
        self.split = make_tiled_split(mesh, cfg.ldirect)

    def decompose(self, zf: ZFields) -> ZFields:
        """Host-side tiling of one processed field stack + device_put of
        each tile onto its owner (the mpif_gf_send_vars analog: one
        transfer per wind read, no per-step broadcast)."""
        zt = decompose_zfields(zf, self.nty, self.ntx, self.halo,
                               self.nx_field, self.xglobal)
        put = lambda a: None if a is None else jax.device_put(a,
                                                              self.sharding)
        return ZFields(f3d=put(zt.f3d), f2d=put(zt.f2d),
                       clouds=put(zt.clouds), vdep=put(zt.vdep),
                       height=zt.height)

    def shard_initial(self, p: Particles, local_cap: int | None = None
                      ) -> Particles:
        """Group the release-scheduled particle buffer by owning tile
        (tile-major layout) and shard it one-tile-per-device."""
        from .domain import FieldTiles, shard_by_tile
        if local_cap is None:
            local_cap = plan_tile_capacity(
                np.asarray(p.x_hi), np.asarray(p.y_hi),
                np.asarray(p.active), self.ntx, self.nty,
                self.tx, self.ty)
        self.local_cap = local_cap
        ftdims = FieldTiles(tiles=jnp.zeros(1), x0=jnp.zeros(1),
                            y0=jnp.zeros(1), ntx=self.ntx, nty=self.nty,
                            tx=self.tx, ty=self.ty, halo=self.halo)
        src = {k: np.asarray(getattr(p, k)) for k in Particles._fields}
        # shard_by_tile places only ACTIVE particles; release-scheduled
        # slots are inactive until their start time, so group by
        # position with the scheduling state carried along
        tiled = shard_by_tile_scheduled(src, ftdims, local_cap)
        return Particles(**{k: jax.device_put(jnp.asarray(v),
                                              self.sharding)
                            for k, v in tiled.items()})

    def regroup(self, p: Particles, new_cap: int) -> Particles:
        """Dynamic rebalance (mpif_calculate_part_redist /
        mpif_redist_part, mpi_mod.f90:566-658): re-group every
        schedulable slot by its CURRENT owning tile at a larger per-tile
        capacity.  Host-side and rare — invoked only when migration
        keeps deferring particles because a hot tile is full, so the
        occasional gather + recompile beats losing physics to an
        indefinitely-parked particle.  Particles stuck in a foreign
        tile's halo land back on their owner here."""
        from .domain import FieldTiles
        ftdims = FieldTiles(tiles=jnp.zeros(1), x0=jnp.zeros(1),
                            y0=jnp.zeros(1), ntx=self.ntx, nty=self.nty,
                            tx=self.tx, ty=self.ty, halo=self.halo)
        src = {k: np.asarray(getattr(p, k)) for k in Particles._fields}
        tiled = shard_by_tile_scheduled(src, ftdims, new_cap)
        self.local_cap = new_cap
        return Particles(**{k: jax.device_put(jnp.asarray(v),
                                              self.sharding)
                            for k, v in tiled.items()})


def shard_by_tile_scheduled(p_np: dict, ft, local_cap: int):
    """Tile-major grouping of ALL schedulable slots (active now or
    releasing later), not just currently-active ones — the release
    schedule pre-assigns every slot to the tile owning its release
    position.  Raises only if a tile genuinely cannot hold its assigned
    slots at the planned capacity."""
    from ..core.state import ITRA_INACTIVE
    x = np.asarray(p_np["x_hi"])
    y = np.asarray(p_np["y_hi"])
    itra = np.asarray(p_np["itra"])
    schedulable = itra != ITRA_INACTIVE
    it = np.clip((x // ft.tx).astype(int), 0, ft.ntx - 1)
    jt = np.clip((y // ft.ty).astype(int), 0, ft.nty - 1)
    tid = jt * ft.ntx + it
    ntile = ft.ntx * ft.nty
    out = {}
    for name, arr in p_np.items():
        arr = np.asarray(arr)
        buf = np.zeros((ntile * local_cap,) + arr.shape[1:], arr.dtype)
        if name in ("itra", "itrasplit"):
            buf[:] = ITRA_INACTIVE
        out[name] = buf
    fill = np.zeros(ntile, int)
    for i in np.argsort(tid, kind="stable"):
        if not schedulable[i]:
            continue
        t = tid[i]
        if fill[t] >= local_cap:
            raise ValueError(
                f"tile {t} over planned capacity {local_cap}; raise the "
                "tile_local_cap slack (release hot-spot)")
        j = t * local_cap + fill[t]
        for name in out:
            out[name][j] = np.asarray(p_np[name])[i]
        fill[t] += 1
    return out


def partition_boundary(bs, nty: int, ntx: int, tx: int, ty: int,
                       halo: int, nx_global: int):
    """Host-side split of a regional domain-fill BoundaryState by
    OWNING TILE (init_domainfill_mpi.f90 analog): every boundary site
    (one vertical layer of one boundary column) belongs to exactly one
    tile, its flux accumulator is site-local, and its emitted particles
    land within half a cell of the column — inside the owner's halo —
    so the whole boundary condition runs tile-locally with NO
    cross-device communication.  Returns a BoundaryState whose arrays
    gain a leading (nty*ntx) tile axis (padded to the max per-tile site
    count; pad sites have valid=False) with col_flat rewritten to the
    TILE-LOCAL haloed linear index."""
    from ..core.domainfill import BoundaryState
    col = np.asarray(bs.col_flat)
    valid = np.asarray(bs.valid)
    jy = col // nx_global
    ix = col % nx_global
    it = np.clip(ix // tx, 0, ntx - 1)
    jt = np.clip(jy // ty, 0, nty - 1)
    tid = jt * ntx + it
    ntile = ntx * nty
    txh = tx + 2 * halo
    counts = np.bincount(tid[valid], minlength=ntile)
    smax = max(int(counts.max()), 1)

    ix_l = ix - (it * tx - halo)
    jy_l = jy - (jt * ty - halo)
    col_local = jy_l * txh + ix_l

    out = {}
    for name in BoundaryState._fields:
        a = np.asarray(getattr(bs, name))
        if a.ndim == 0 or name in ("xpp", "xlim", "ylim"):
            # per-tile replicated scalars/windows
            out[name] = np.broadcast_to(a[None], (ntile,) + a.shape).copy()
            continue
        fill = False if a.dtype == bool else 0
        buf = np.full((ntile, smax) + a.shape[1:], fill, a.dtype)
        out[name] = buf
    fill_ix = np.zeros(ntile, int)
    for s in np.nonzero(valid)[0]:
        t = tid[s]
        k = fill_ix[t]
        fill_ix[t] += 1
        for name in BoundaryState._fields:
            a = np.asarray(getattr(bs, name))
            if a.ndim == 0 or name in ("xpp", "xlim", "ylim"):
                continue
            out[name][t, k] = col_local[s] if name == "col_flat" else a[s]
    return BoundaryState(**{k: jnp.asarray(v) for k, v in out.items()})


def make_tiled_boundcond(mesh: Mesh, ntx: int, mdomainfill: int,
                         ldirect: int, nclassunc: int, check_x: bool,
                         has_vdep: bool):
    """Tile-local boundcond_domainfill (boundcond_domainfill_mpi.f90
    analog): each device kills its out-of-window particles, integrates
    mass inflow through ITS boundary sites from its haloed field tile,
    and emits new particles into ITS OWN slot buffer (per-tile
    prefix-sum allocation, like make_tiled_split)."""
    from ..core.domainfill import BoundaryState, boundcond_domainfill
    p_specs = _particle_specs()
    z_specs = _ZSpecs.make(has_vdep)
    b_specs = BoundaryState(*[P((AX_TY, AX_TX))]
                            * len(BoundaryState._fields))

    def _local(p, bs_t, z0t, z1t, itime, mt0, mt1, key, lsynctime,
               itsplit, ylat0, dy):
        it = lax.axis_index(AX_TX)
        jt = lax.axis_index(AX_TY)
        key = jax.random.fold_in(key, jt * ntx + it)
        bs = BoundaryState(*[a[0] for a in bs_t])
        p2, bs2 = boundcond_domainfill(
            p, bs, _local_zfields(z0t), _local_zfields(z1t), itime,
            mt0, mt1, key, lsynctime, itsplit, ylat0, dy,
            mdomainfill=mdomainfill, ldirect=ldirect,
            nclassunc=nclassunc, check_x=check_x)
        return p2, BoundaryState(*[a[None] for a in bs2])

    fn = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(p_specs, b_specs, z_specs, z_specs,
                  P(), P(), P(), P(), P(), P(), P(), P()),
        out_specs=(p_specs, b_specs))
    return jax.jit(fn)
