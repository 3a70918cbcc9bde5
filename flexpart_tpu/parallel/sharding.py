"""Particle data-parallelism over a device mesh.

Replacement for the reference's MPI layer (mpi_mod.f90, 2977
LoC; see SURVEY.md §2.8): instead of per-rank particle arrays with
explicit MPI transfers (`mpif_redist_part`, mpi_mod.f90:661-858) and
blocking field broadcasts (`mpif_gf_send_vars`, :1258-1427), the SoA
particle state is ONE logically-global array sharded along its capacity
axis over a `jax.sharding.Mesh`; met fields are replicated (the reference
semantics — every rank holds the full grid, README_PARALLEL.md:60-66);
output accumulators are kept as per-device partials with a leading device
axis and reduced ONLY at output time, the analog of `mpif_tm_reduce_grid`
(mpi_mod.f90:2395-2503).

Because shard placement is static and releases fill slots round-robin
across shards (core/release.py orders by schedule time), explicit dynamic
load rebalancing (`mpif_calculate_part_redist`, mpi_mod.f90:566-658) is
unnecessary: every shard holds a statistically identical particle mix.

RNG decorrelation across shards is free: draws are keyed per particle
slot + step (core/rng.py), so the same physical particle gets the same
stream regardless of which device owns it — stronger than the reference's
per-rank `mp_seed` offset (mpi_mod.f90:75).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.advance import StepConfig, StepParams, advance_all, StepDiag
from ..core.state import Particles
from ..grid.conccalc import ConcConfig, _conccalc_impl
from ..grid.outgrid import Accumulators, OutputGridGeometry

PARTICLE_AXIS = "p"


def particle_mesh(n_devices: int | None = None,
                  devices=None, axis: str = PARTICLE_AXIS) -> Mesh:
    """1-D mesh over which particle arrays are sharded."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    import numpy as np
    return Mesh(np.asarray(devices), (axis,))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(PARTICLE_AXIS))


def shard_particles(p: Particles, mesh: Mesh) -> Particles:
    """Place the SoA particle arrays with the capacity axis split across
    the mesh.  Capacity must be a multiple of the mesh size (pad slots are
    free — they are just inactive)."""
    ndev = mesh.devices.size
    if p.capacity % ndev:
        raise ValueError(f"capacity {p.capacity} not divisible by {ndev} "
                         "devices; round capacity up")
    sh = particle_sharding(mesh)
    return jax.tree.map(lambda a: jax.device_put(a, sh), p)


def replicate(tree, mesh: Mesh):
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sh), tree)


# ---------------------------------------------------------------------------
# sharded advance: pure particle-parallel, zero communication inside the step
# (the only collective is the scalar diagnostic psum)
# ---------------------------------------------------------------------------

def make_sharded_advance(mesh: Mesh, cfg: StepConfig):
    """Returns a jitted (p, z0, z1, itime, mt0, mt1, key, prm) -> (p, diag)
    with particles sharded over the mesh and fields replicated."""
    p_specs = Particles(*[P(PARTICLE_AXIS)] * len(Particles._fields))

    def _local(p, z0, z1, itime, mt0, mt1, key, prm):
        # decorrelate shards: fold device index into the step key
        key = jax.random.fold_in(key, jax.lax.axis_index(PARTICLE_AXIS))
        p, diag = advance_all(p, z0, z1, itime, mt0, mt1, key, cfg, prm)
        return p, StepDiag(
            n_active=jax.lax.psum(diag.n_active, PARTICLE_AXIS),
            n_exited=jax.lax.psum(diag.n_exited, PARTICLE_AXIS),
            nan_count=jax.lax.psum(diag.nan_count, PARTICLE_AXIS))

    fn = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(p_specs, P(), P(), P(), P(), P(), P(), P()),
        out_specs=(p_specs, StepDiag(P(), P(), P())),
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# sharded conccalc: per-device partial accumulators, reduce at output only
# ---------------------------------------------------------------------------

def zero_acc_partials(mesh: Mesh, geo: OutputGridGeometry, nspec: int,
                      npointspec: int, nclassunc: int = 1,
                      nage: int = 1) -> Accumulators:
    """Accumulators with a leading device axis, sharded so each device
    owns one full-grid partial (unc_mod.f90 `*0` variants analog)."""
    ndev = mesh.devices.size
    shape3 = (ndev, nage, nclassunc, npointspec,
              geo.nzg, geo.nyg, geo.nxg, nspec)
    shape2 = (ndev, nage, nclassunc, npointspec, geo.nyg, geo.nxg, nspec)
    sh = particle_sharding(mesh)
    return Accumulators(
        gridunc=jax.device_put(jnp.zeros(shape3, jnp.float32), sh),
        wetgridunc=jax.device_put(jnp.zeros(shape2, jnp.float32), sh),
        drygridunc=jax.device_put(jnp.zeros(shape2, jnp.float32), sh),
        outnum=jax.device_put(jnp.zeros((ndev,), jnp.float32), sh),
    )


def make_sharded_conccalc(mesh: Mesh, outheights, cfg: ConcConfig):
    """Returns jitted (acc_partial, p, zf, itime, lage, weight) ->
    acc_partial; each device scatter-adds its particle shard into its own
    full-grid partial — no communication."""
    import numpy as np
    oh = jnp.asarray(np.asarray(outheights, jnp.float32))
    p_specs = Particles(*[P(PARTICLE_AXIS)] * len(Particles._fields))
    a_specs = Accumulators(*[P(PARTICLE_AXIS)] * len(Accumulators._fields))

    def _local(acc, p, zf, itime, lage, weight):
        # local shapes carry the leading device axis of length 1
        acc_in = Accumulators(gridunc=acc.gridunc[0],
                              wetgridunc=acc.wetgridunc[0],
                              drygridunc=acc.drygridunc[0],
                              outnum=acc.outnum[0])
        out = _conccalc_impl(acc_in, p, zf, itime, lage, weight, cfg, oh)
        return Accumulators(gridunc=out.gridunc[None],
                            wetgridunc=out.wetgridunc[None],
                            drygridunc=out.drygridunc[None],
                            outnum=out.outnum[None])

    fn = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(a_specs, p_specs, P(), P(), P(), P()),
        out_specs=a_specs,
    )
    return jax.jit(fn, static_argnames=())


def pad_particles(p: Particles, multiple: int) -> Particles:
    """Append inactive slots so capacity is a multiple of the mesh size
    (pad slots never activate: itra stays at the inactive sentinel)."""
    from ..core.state import empty_particles
    cap = p.capacity
    rem = cap % multiple
    if rem == 0:
        return p
    extra = empty_particles(multiple - rem, p.nspec)
    return Particles(*[jnp.concatenate([a, b], axis=0)
                       for a, b in zip(p, extra)])


def make_sharded_depo_scatter(mesh: Mesh, scatter_fn):
    """Wrap a depokernel scatter so each device adds its particle shard's
    deposits into its own per-device partial 2-D grid (leading device
    axis), the wet/drydepokernel analog of make_sharded_conccalc.
    Returns jitted (grid_partial, deposit(nspec,N), p, nage_idx, kp) ->
    grid_partial."""
    p_specs = Particles(*[P(PARTICLE_AXIS)] * len(Particles._fields))

    def _local(grid, deposit, p, nage_idx, kp):
        return scatter_fn(grid[0], deposit, p, nage_idx, kp)[None]

    fn = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P(PARTICLE_AXIS), P(None, PARTICLE_AXIS), p_specs,
                  P(PARTICLE_AXIS), P(PARTICLE_AXIS)),
        out_specs=P(PARTICLE_AXIS),
    )
    return jax.jit(fn)


@jax.jit
def reduce_acc_partials(acc: Accumulators) -> Accumulators:
    """Sum the per-device partials into one grid — the output-time
    reduction (mpif_tm_reduce_grid analog); XLA lowers this to an
    all-reduce over ICI."""
    return Accumulators(
        gridunc=acc.gridunc.sum(0), wetgridunc=acc.wetgridunc.sum(0),
        drygridunc=acc.drygridunc.sum(0),
        # every device adds the same sample weight to its partial, so the
        # global sample count is the mean, not the sum
        outnum=acc.outnum.mean(0))
