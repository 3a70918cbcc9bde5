"""Domain decomposition of met fields — groundwork.

The reference replicates the full met grid on every MPI rank
(README_PARALLEL.md:60-66); the memory ceiling this imposes is the
compile-time `par_mod` grid dimensioning.  This design instead
splits the (NF3, nz, ny, nx) field stack into lat/lon tiles with a halo
ring sized by the maximum per-step particle displacement (CFL) plus the
interpolation stencil, so each chip holds only its tile:

  * tiles are built host-side at field load time (the halo is filled by
    slicing the neighbouring tiles' interiors — cyclic in x for global
    grids, clamped at the poles), so no device-side halo exchange is
    needed when a new wind time arrives: the async reader thread
    (run/simulation.py) overlaps the whole rebuild with particle compute;
  * the tile stack has a leading tile axis, shard it with
    NamedSharding(mesh2d, P(("ty","tx"))) and shard_map the advance so
    each device sees exactly its haloed tile;
  * particles interpolate in TILE-LOCAL coordinates: identical bilinear
    weights as the global path (core/interp.py) with the corner indices
    offset by the tile origin, validated to bit-match the global gather;
  * particles that step outside their tile's OWNED region (but stay
    within the halo) are migrated to the owning neighbour between steps
    with `ppermute` ring passes (x then y), replacing the reference's
    `mpif_redist_part` point-to-point transfers (mpi_mod.f90:661-858).

This module provides the tiling, ownership, and tile-local interpolation
pieces with bit-exactness tests; the shard_map'ped advance + ppermute
migration wire-up lands on top of it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class FieldTiles(NamedTuple):
    """Haloed lat/lon tiles of one field stack.

    tiles[t] covers mother-grid columns [x0[t]-halo, x0[t]+tx+halo) and
    rows [y0[t]-halo, y0[t]+ty+halo), x wrapped cyclically (global
    grids) and y clamped at the poles."""
    tiles: jnp.ndarray     # (ntiles, NF3, nz, ty+2h, tx+2h)
    x0: jnp.ndarray        # (ntiles,) i32 owned-region origin column
    y0: jnp.ndarray        # (ntiles,) i32 owned-region origin row
    ntx: int               # tiles in x
    nty: int               # tiles in y
    tx: int                # owned columns per tile
    ty: int                # owned rows per tile
    halo: int

    @property
    def ntiles(self) -> int:
        return self.ntx * self.nty


def halo_for(umax: float, lsynctime: float, dx_deg: float,
             ylat_max: float = 85.0) -> int:
    """Halo width in grid cells from the CFL bound: worst-case zonal
    displacement at the highest resolved latitude plus one cell for the
    bilinear stencil and one for the Petterssen predictor point."""
    m_per_deg = 111198.5 * max(np.cos(np.deg2rad(ylat_max)), 1e-2)
    cells = umax * abs(lsynctime) / (dx_deg * m_per_deg)
    return int(np.ceil(cells)) + 2


def decompose(f3d, nty: int, nx_field: int, ntx: int, halo: int,
              xglobal: bool) -> FieldTiles:
    """Tile a (NF3, nz, ny, nx) stack.  ``nx_field`` excludes the cyclic
    duplicate column (grid.nxfield); ny and nx_field must divide evenly
    by nty/ntx (pad the grid first otherwise)."""
    f = np.asarray(f3d)
    nf, nz, ny, nx = f.shape
    assert ny % nty == 0 and nx_field % ntx == 0, \
        f"({ny},{nx_field}) not divisible by ({nty},{ntx})"
    ty = ny // nty
    tx = nx_field // ntx
    tiles = np.empty((nty * ntx, nf, nz, ty + 2 * halo, tx + 2 * halo),
                     f.dtype)
    x0s = np.empty(nty * ntx, np.int32)
    y0s = np.empty(nty * ntx, np.int32)
    # row index map with pole clamping
    for jt in range(nty):
        y0 = jt * ty
        rows = np.clip(np.arange(y0 - halo, y0 + ty + halo), 0, ny - 1)
        for it in range(ntx):
            x0 = it * tx
            cols = np.arange(x0 - halo, x0 + tx + halo)
            if xglobal:
                cols = cols % nx_field
            else:
                cols = np.clip(cols, 0, nx - 1)
            t = jt * ntx + it
            tiles[t] = f[:, :, rows[:, None], cols[None, :]]
            x0s[t] = x0
            y0s[t] = y0
    return FieldTiles(tiles=jnp.asarray(tiles), x0=jnp.asarray(x0s),
                      y0=jnp.asarray(y0s), ntx=ntx, nty=nty, tx=tx,
                      ty=ty, halo=halo)


def tile_of(x, y, ft: FieldTiles):
    """Owning tile id for mother-grid positions (x, y)."""
    it = jnp.clip((x // ft.tx).astype(jnp.int32), 0, ft.ntx - 1)
    jt = jnp.clip((y // ft.ty).astype(jnp.int32), 0, ft.nty - 1)
    return jt * ft.ntx + it


def local_coords(x, y, tile_id, ft: FieldTiles):
    """Mother-grid (x, y) -> tile-local haloed coordinates."""
    xl = x - ft.x0[tile_id] + ft.halo
    yl = y - ft.y0[tile_id] + ft.halo
    return xl, yl


def in_reach(xl, yl, ft: FieldTiles):
    """Whether a tile-local position can still be interpolated from this
    tile (inside the halo, with one cell of stencil room)."""
    return ((xl >= 0) & (xl <= ft.tx + 2 * ft.halo - 2)
            & (yl >= 0) & (yl <= ft.ty + 2 * ft.halo - 2))


def interp_tile(ft: FieldTiles, tile_id, field_idx: int, x, y, kz):
    """Bilinear interpolation of one field level from each particle's
    owning tile — the tile-local analog of the fused global gather
    (core/interp.py horiz_weights + gather).  Used by the correctness
    tests; the sharded advance applies the same offset arithmetic inside
    shard_map where tile_id is implicit (one tile per device)."""
    xl, yl = local_coords(x, y, tile_id, ft)
    txh = ft.tx + 2 * ft.halo
    tyh = ft.ty + 2 * ft.halo
    ix = jnp.clip(jnp.floor(xl).astype(jnp.int32), 0, txh - 2)
    jy = jnp.clip(jnp.floor(yl).astype(jnp.int32), 0, tyh - 2)
    ddx = jnp.clip(xl - ix, 0.0, 1.0)
    ddy = jnp.clip(yl - jy, 0.0, 1.0)
    f = ft.tiles[tile_id, field_idx, kz]          # (N, tyh, txh)
    n = jnp.arange(x.shape[0])
    v00 = f[n, jy, ix]
    v10 = f[n, jy, ix + 1]
    v01 = f[n, jy + 1, ix]
    v11 = f[n, jy + 1, ix + 1]
    return ((1 - ddx) * (1 - ddy) * v00 + ddx * (1 - ddy) * v10
            + (1 - ddx) * ddy * v01 + ddx * ddy * v11)


# ---------------------------------------------------------------------------
# particle migration between tiles (mpif_redist_part replacement):
# after a tiled advance step, particles that left their tile's owned
# region move to the owning neighbour with ppermute ring passes — one in
# x (cyclic), one in y.  The CFL halo guarantees at most one tile of
# travel per step, so a single +-1 exchange per axis is complete.
# ---------------------------------------------------------------------------

import jax
from jax import lax

from ..core.state import ITRA_INACTIVE, Particles

AX_TY = "ty"
AX_TX = "tx"


def _pack(p: Particles, mask, m: int):
    """First-m masked particles into a fixed-size message buffer.
    Returns (msg Particles of length m, valid (m,), sent (N,),
    slot (N,) — each sent particle's message-buffer index)."""
    rank = jnp.cumsum(mask) - 1
    can = mask & (rank < m)
    slot = jnp.where(can, rank, m)
    msg = jax.tree.map(
        lambda a: jnp.zeros((m,) + a.shape[1:], a.dtype
                            ).at[slot].set(a, mode="drop"), p)
    valid = jnp.zeros(m, bool).at[jnp.where(can, slot, m)].set(
        True, mode="drop")
    return msg, valid, can, slot


def _deactivate(p: Particles, sent):
    return p._replace(active=p.active & ~sent,
                      itra=jnp.where(sent, ITRA_INACTIVE, p.itra))


def _merge(p: Particles, msg: Particles, valid):
    """Scatter valid incoming particles into free slots (prefix-rank
    matching, same pattern as core/split.py).  Returns the merged
    buffer and the (m,) mask of incoming slots actually placed."""
    n = p.capacity
    free = (~p.active) & ((p.itra == ITRA_INACTIVE)
                          | (p.itra != p.itramem))
    free_rank = jnp.cumsum(free) - 1
    n_free = free_rank[-1] + 1
    slot_of_rank = jnp.full(n, n, jnp.int32).at[
        jnp.where(free, free_rank, n)].set(
            jnp.arange(n, dtype=jnp.int32), mode="drop")
    in_rank = jnp.cumsum(valid) - 1
    granted = valid & (in_rank < n_free)
    slot = jnp.where(granted,
                     slot_of_rank[jnp.clip(in_rank, 0, n - 1)], n)
    out = {}
    for name in Particles._fields:
        arr = getattr(p, name)
        out[name] = arr.at[slot].set(getattr(msg, name), mode="drop")
    return Particles(**out), granted


def _exchange(p: Particles, off, axis: str, sign: int, m: int):
    """Send particles with tile offset ``sign`` one step along ``axis``.

    Two-phase so a full destination NEVER loses particles
    (mpi_mod.f90's counted sends have the same guarantee): the receiver
    merges what fits and ppermutes the per-slot grant mask back; only
    granted particles are deactivated at the sender.  Denied particles
    stay active on the sender (in its halo) and retry — next round,
    next step, or after the Simulation-level regroup rebalance.  The
    receiver's free-slot count excludes its own outgoing particles
    (their grant is unknown at merge time), so two full tiles swapping
    particles defer one step instead of deadlocking or dropping."""
    n_ax = lax.axis_size(axis)
    mask = p.active & (off == sign)
    msg, valid, sent, mslot = _pack(p, mask, m)
    perm = [(i, (i + sign) % n_ax) for i in range(n_ax)]
    inv = [((i + sign) % n_ax, i) for i in range(n_ax)]
    msg_r = jax.tree.map(lambda a: lax.ppermute(a, axis, perm), msg)
    valid_r = lax.ppermute(valid, axis, perm)
    p, granted_r = _merge(p, msg_r, valid_r)
    granted_back = lax.ppermute(granted_r, axis, inv)      # (m,)
    placed = sent & jnp.pad(granted_back, (0, 1))[
        jnp.clip(mslot, 0, m)]
    p = _deactivate(p, placed)
    n_denied = jnp.sum(sent & ~placed)
    n_stuck = jnp.sum(mask & ~sent)      # message buffer overflow
    return p, n_denied + n_stuck


def migrate_local(p: Particles, ntx: int, nty: int, tx: int, ty: int,
                  msg_cap: int, rounds_x: int = 1, rounds_y: int = 1):
    """One migration round for THIS tile's particle buffer; call inside
    shard_map over a ("ty","tx") mesh.  Returns (particles, n_unplaced)
    where n_unplaced counts particles that could not be moved this round
    (message-buffer overflow or full destination) — they stay put /
    vanish from the count and retry next step via the halo slack."""
    it = lax.axis_index(AX_TX)
    jt = lax.axis_index(AX_TY)
    n_bad = jnp.int32(0)
    # x pass (cyclic); rounds_x > 1 moves multi-tile hops (polar-cap
    # wraps can teleport a particle across many x tiles in one step —
    # each round sends particles one neighbour closer, shortest way
    # around the ring)
    dest_it = jnp.clip((p.x // tx).astype(jnp.int32), 0, ntx - 1)
    off = ((dest_it - it + ntx // 2 + ntx) % ntx) - ntx // 2
    off = jnp.where(p.active, off, 0)
    for _ in range(max(rounds_x, 1)):
        for sign in (1, -1):
            if ntx > 1:
                hop = jnp.clip(off, -1, 1)
                p, nb = _exchange(p, hop, AX_TX, sign, msg_cap)
                n_bad = n_bad + nb
                dest_it = jnp.clip((p.x // tx).astype(jnp.int32),
                                   0, ntx - 1)
                off = ((dest_it - it + ntx // 2 + ntx) % ntx) - ntx // 2
                off = jnp.where(p.active, off, 0)
    # y pass (no wrap: pole BCs keep y in range)
    dest_jt = jnp.clip((p.y // ty).astype(jnp.int32), 0, nty - 1)
    offy = jnp.where(p.active, dest_jt - jt, 0)
    for _ in range(max(rounds_y, 1)):
        for sign in (1, -1):
            if nty > 1:
                hop = jnp.clip(offy, -1, 1)
                p, nb = _exchange(p, hop, AX_TY, sign, msg_cap)
                n_bad = n_bad + nb
                dest_jt = jnp.clip((p.y // ty).astype(jnp.int32),
                                   0, nty - 1)
                offy = jnp.where(p.active, dest_jt - jt, 0)
    return p, lax.psum(n_bad, (AX_TY, AX_TX))


def make_migrate(mesh, ntx: int, nty: int, tx: int, ty: int,
                 msg_cap: int = 4096):
    """Jitted migration over a 2-D ("ty","tx") mesh: particle buffers
    sharded one-tile-per-device along their capacity axis."""
    from jax.sharding import PartitionSpec as P
    p_specs = Particles(*[P((AX_TY, AX_TX))] * len(Particles._fields))

    def _fn(p):
        return migrate_local(p, ntx, nty, tx, ty, msg_cap)

    return jax.jit(jax.shard_map(
        _fn, mesh=mesh, in_specs=(p_specs,),
        out_specs=(p_specs, P()),
    ))


def shard_by_tile(p_np: dict, ft: FieldTiles, local_cap: int):
    """Host-side: group a global particle population by owning tile into
    a (ntiles*local_cap,) SoA layout (tile-major) ready to shard."""
    import numpy as np
    x = np.asarray(p_np["x_hi"])
    y = np.asarray(p_np["y_hi"])
    act = np.asarray(p_np["active"])
    it = np.clip((x // ft.tx).astype(int), 0, ft.ntx - 1)
    jt = np.clip((y // ft.ty).astype(int), 0, ft.nty - 1)
    tid = jt * ft.ntx + it
    out = {}
    ntile = ft.ntiles
    for name, arr in p_np.items():
        arr = np.asarray(arr)
        buf = np.zeros((ntile * local_cap,) + arr.shape[1:], arr.dtype)
        if name == "itra":
            buf[:] = ITRA_INACTIVE
        out[name] = buf
    fill = np.zeros(ntile, int)
    order = np.argsort(tid, kind="stable")
    for i in order:
        if not act[i]:
            continue
        t = tid[i]
        if fill[t] >= local_cap:
            raise ValueError(f"tile {t} over local capacity {local_cap}")
        j = t * local_cap + fill[t]
        for name in out:
            out[name][j] = np.asarray(p_np[name])[i]
        fill[t] += 1
    return out


# ---------------------------------------------------------------------------
# tiled advance: the full distributed step — each device advances its
# particles against ITS haloed field tile (tile-local coordinates, BCs
# deferred), then global wrap/pole/exit handling, then ppermute migration.
# ---------------------------------------------------------------------------

from ..core.advance import StepConfig, StepParams, _apply_bcs, advance_all
from ..met.fields import ZFields


def _tile_indices(ny: int, nx_field: int, nty: int, ntx: int, halo: int,
                  xglobal: bool):
    """Row/col gather maps for every tile: rows (nty, ty+2h) pole-clamped,
    cols (ntx, tx+2h) seam-wrapped.  Ceil-sized tiles: when the grid
    doesn't divide, the last tiles' pad rows/cols clamp at the pole /
    wrap at the seam — duplicated field values in cells no particle
    visits."""
    ty = -(-ny // nty)
    tx = -(-nx_field // ntx)
    rows = np.stack([np.clip(np.arange(j * ty - halo, j * ty + ty + halo),
                             0, ny - 1) for j in range(nty)])
    cols = []
    for i in range(ntx):
        c = np.arange(i * tx - halo, i * tx + tx + halo)
        cols.append(c % nx_field if xglobal
                    else np.clip(c, 0, nx_field - 1))
    return rows, np.stack(cols)


def decompose_zfields(zf: ZFields, nty: int, ntx: int, halo: int,
                      nx_field: int, xglobal: bool) -> ZFields:
    """Tile every component of a ZFields stack; each output array gains a
    leading (nty*ntx) tile axis to shard with P(("ty","tx")).  height is
    column-independent and stays replicated."""
    rows, cols = _tile_indices(zf.f3d.shape[-2], nx_field, nty, ntx,
                               halo, xglobal)

    def tile(arr):
        a = np.asarray(arr)
        out = np.stack([a[..., rows[jt][:, None], cols[it][None, :]]
                        for jt in range(nty) for it in range(ntx)])
        return jnp.asarray(out)

    return ZFields(f3d=tile(zf.f3d), f2d=tile(zf.f2d),
                   clouds=tile(zf.clouds),
                   vdep=None if zf.vdep is None else tile(zf.vdep),
                   height=zf.height)


def make_tiled_advance(mesh, cfg: StepConfig, ntx: int, nty: int,
                       tx: int, ty: int, halo: int, msg_cap: int = 4096,
                       return_pre: bool = False):
    """Jitted distributed step over a ("ty","tx") mesh: particles and
    field tiles sharded one-tile-per-device.  Returns
    (p, z0_tiles, z1_tiles, itime, mt0, mt1, key, prm) ->
    (p, n_active, n_unplaced).

    return_pre=True appends the PRE-MIGRATION particle state (global
    positions, BCs and domain-exit kills applied, slots still aligned
    with the INPUT buffer) to the outputs.  Consumers that pair
    before/after states per slot — gross-flux face crossings
    (calcfluxes.f90 uses xold/xnew of the same particle) and
    initial-condition scatters for particles the step terminated
    (timemanager.f90:631) — must use this state: after migration a slot
    may hold a different particle."""
    from jax.sharding import PartitionSpec as P
    txh = tx + 2 * halo
    tyh = ty + 2 * halo
    # polar caps stay ON in tile mode: the stereographic update runs in
    # global coordinates (prm.tile_x0/nxm_pol) and multi-hop migration
    # routes trans-polar x jumps; only the Petterssen corrector is
    # skipped for cap-ending particles (advance.py can_pett gate)
    cfg_t = cfg._replace(nx=txh, ny=tyh, xglobal=False, tile_mode=True,
                         nest_nx=0, nest_ny=0, nests=())
    rounds_x = ntx // 2 if cfg.polar else 1
    rounds_y = max(nty // 2, 1) if cfg.polar else 1
    p_specs = Particles(*[P((AX_TY, AX_TX))] * len(Particles._fields))
    z_specs = ZFields(f3d=P((AX_TY, AX_TX)), f2d=P((AX_TY, AX_TX)),
                      clouds=P((AX_TY, AX_TX)),
                      vdep=P((AX_TY, AX_TX)), height=P())

    def _local(p, z0t, z1t, itime, mt0, mt1, key, prm):
        it = lax.axis_index(AX_TX)
        jt = lax.axis_index(AX_TY)
        x0 = (it * tx - halo).astype(jnp.float32)
        y0 = (jt * ty - halo).astype(jnp.float32)
        key = jax.random.fold_in(key, jt * ntx + it)
        z0l = ZFields(f3d=z0t.f3d[0], f2d=z0t.f2d[0],
                      clouds=z0t.clouds[0],
                      vdep=None if z0t.vdep is None else z0t.vdep[0],
                      height=z0t.height)
        z1l = ZFields(f3d=z1t.f3d[0], f2d=z1t.f2d[0],
                      clouds=z1t.clouds[0],
                      vdep=None if z1t.vdep is None else z1t.vdep[0],
                      height=z1t.height)
        prm_l = prm._replace(ylat0=prm.ylat0 + y0 * prm.dy,
                             tile_x0=x0,
                             nxm_pol=jnp.float32(cfg.nx - 1))
        pl = p._replace(x_hi=p.x_hi - x0, y_hi=p.y_hi - y0)
        pl, diag = advance_all(pl, z0l, z1l, itime, mt0, mt1, key,
                               cfg_t, prm_l)
        pg = pl._replace(x_hi=pl.x_hi + x0, y_hi=pl.y_hi + y0)
        # global wrap / pole mirror / domain exit (advance.f90:784-808)
        xh, xl, yh, yl, exited = _apply_bcs(cfg, prm, pg.x_hi, pg.x_lo,
                                            pg.y_hi, pg.y_lo)
        kill = pg.active & exited
        pg = pg._replace(
            x_hi=xh, x_lo=xl, y_hi=yh, y_lo=yl,
            active=pg.active & ~kill,
            itra=jnp.where(kill, ITRA_INACTIVE, pg.itra))
        pre = pg
        pg, n_bad = migrate_local(pg, ntx, nty, tx, ty, msg_cap,
                                  rounds_x=rounds_x, rounds_y=rounds_y)
        n_act = lax.psum(jnp.sum(pg.active.astype(jnp.int32)),
                         (AX_TY, AX_TX))
        if return_pre:
            return pg, n_act, n_bad, pre
        return pg, n_act, n_bad

    out_specs = (p_specs, P(), P()) + ((p_specs,) if return_pre else ())
    return jax.jit(jax.shard_map(
        _local, mesh=mesh,
        in_specs=(p_specs, z_specs, z_specs, P(), P(), P(), P(), P()),
        out_specs=out_specs,
    ))
