"""Structural communication contract of the sharded operators.

The scaling claim of the SPMD design (README/PERF: "one psum per adjoint"
for channel-expert sharding, "one psum per forward" for λ-sharding, two
collectives — the provable minimum — for the 2-D normal) was previously
enforced only by construction.  These tests inspect the jaxpr of every
sharded entry point and assert the exact collective count per EXECUTED
path (a `lax.switch` counts the maximum over its branches — each device
runs exactly one), and that no other collective primitive (all_gather /
ppermute / all_to_all / reduce_scatter / pgather) appears anywhere.

A compiled-HLO spot check on the channel-expert normal additionally pins
the count after XLA's SPMD partitioner (`all-reduce` ops in the optimized
module).
"""

import re
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surfh_tpu.parallel.fusion import ShardedSpectro, make_mesh
from surfh_tpu.parallel.lambda_sharded import LambdaShardedChannel
from surfh_tpu.parallel.mesh2d import ShardedSpectro2D, make_mesh_2d
from surfh_tpu.simulation.synthetic import make_model

# every JAX collective primitive that moves data between devices; psum is
# the only one the design permits
COMM_PRIMS = {
    "psum", "all_gather", "all_to_all", "ppermute", "psum_scatter",
    "reduce_scatter", "pgather", "pmax", "pmin", "pbroadcast",
    "psum_invariant", "all_gather_invariant",
}


def _iter_subjaxprs(value):
    """Yield Jaxpr objects reachable from an eqn param value."""
    from jax._src.core import ClosedJaxpr, Jaxpr

    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _iter_subjaxprs(v)


def count_collectives(jaxpr) -> Counter:
    """Collective-primitive counts per executed path.

    `cond` (which `lax.switch` lowers to) contributes the per-primitive
    MAXIMUM over its branches — each device executes exactly one branch.
    Loop bodies (`scan`/`while`) count once per primitive occurrence and
    are additionally asserted collective-free (a collective inside a loop
    would multiply per iteration and break the contract silently).
    """
    total = Counter()
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in COMM_PRIMS:
            total[name] += 1
        if name == "cond":
            branch_counts = [
                count_collectives(b) for b in _iter_subjaxprs(
                    eqn.params["branches"])
            ]
            merged = Counter()
            for bc in branch_counts:
                for k, c in bc.items():
                    merged[k] = max(merged[k], c)
            total += merged
        else:
            in_loop = name in ("scan", "while")
            for sub in _iter_subjaxprs(list(eqn.params.values())):
                sub_counts = count_collectives(sub)
                if in_loop:
                    assert not sub_counts, (
                        f"collective inside {name} loop: {dict(sub_counts)}"
                    )
                total += sub_counts
    return total


def assert_comm(fn, args, n_psum, what):
    counts = count_collectives(jax.make_jaxpr(fn)(*args).jaxpr)
    others = {k: v for k, v in counts.items() if k != "psum"}
    assert not others, f"{what}: unexpected collectives {others}"
    assert counts.get("psum", 0) == n_psum, (
        f"{what}: expected exactly {n_psum} psum per application, "
        f"got {counts.get('psum', 0)}"
    )


@pytest.fixture(scope="module")
def tiny_model():
    return make_model(
        im_size=31, n_lambda=24, n_tpl=3, n_channels=3, n_pointings=2,
        n_slit=3, dtype=jnp.float64,
    )


def test_channel_expert_collective_counts(tiny_model):
    """Channel-expert sharding: forward no-comm, adjoint/normal ONE psum."""
    model, setup = tiny_model
    sh = ShardedSpectro(model, make_mesh(len(jax.devices())))
    x = jnp.asarray(setup["maps"], model.dtype)
    y = jnp.zeros((sh.n_dev * sh.per_dev, sh.block), model.dtype)
    assert_comm(sh._forward_sm, (x,), 0, "channel-expert forward")
    assert_comm(sh._adjoint_sm, (y,), 1, "channel-expert adjoint")
    assert_comm(sh._normal_sm, (x,), 1, "channel-expert normal")


def test_window_local_collective_counts():
    """Flagship-mode (window_local, tables-as-args) channel-expert sharding
    keeps the same contract: the tables ride as arguments, not comm."""
    from surfh_tpu.models.spectro import SpectroSigRLSCT
    from surfh_tpu.simulation.synthetic import make_setup

    fx = make_setup(im_size=31, n_lambda=24, n_tpl=3, n_channels=4,
                    n_pointings=2, n_slit=3)
    model = SpectroSigRLSCT(
        fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"],
        fx["wavelength_axis"], fx["instrs"], fx["step_degree"],
        fx["pointings"], dtype=jnp.float32, window_local=True,
        conv_impl="matmul",
    )
    sh = ShardedSpectro(model, make_mesh(len(jax.devices())))
    assert sh.window_local
    x = jnp.zeros(model.ishape, jnp.float32)
    y = jnp.zeros((sh.n_dev * sh.per_dev, sh.block), jnp.float32)
    assert_comm(lambda x: sh._forward_sm(x, sh._tables), (x,), 0,
                "window-local forward")
    assert_comm(lambda y: sh._adjoint_sm(y, sh._tables), (y,), 1,
                "window-local adjoint")
    assert_comm(lambda x: sh._normal_sm(x, sh._tables), (x,), 1,
                "window-local normal")

    # compiled-HLO spot check: after SPMD partitioning the normal op holds
    # exactly one all-reduce family op (start/done pairs count once) and no
    # other collective
    txt = (
        jax.jit(lambda x: sh._normal_sm(x, sh._tables))
        .lower(x).compile().as_text()
    )
    starts = len(re.findall(r"all-reduce-start", txt))
    plain = len(re.findall(r"= \S+ all-reduce\(", txt))
    assert (starts + plain) == 1, (starts, plain)
    for bad in ("all-gather", "collective-permute", "all-to-all",
                "reduce-scatter"):
        assert bad not in txt, f"unexpected {bad} in normal-op HLO"


def test_lambda_sharded_collective_counts():
    """λ-axis sharding: forward ONE psum, adjoint no-comm (replicated y,
    local transpose of the owned λ-columns)."""
    model, _ = make_model(
        im_size=31, n_lambda=26, n_tpl=3, n_channels=1, n_pointings=2,
        n_slit=3, dtype=jnp.float64,
    )
    chan = model.channels[0]
    mesh = make_mesh(len(jax.devices()), axis_name="lam")
    sh = LambdaShardedChannel(chan, n_lambda=26, mesh=mesh)
    cube = jnp.zeros(model.cube_shape, model.dtype)
    y = jnp.zeros(chan.oshape, model.dtype)
    assert_comm(sh._forward_sm, (sh.shard_cube(cube),), 1,
                "lambda-sharded forward")
    assert_comm(sh._adjoint_sm, (y,), 0, "lambda-sharded adjoint")


def test_mesh2d_collective_counts(tiny_model):
    """2-D (chan × λ) mesh: forward ONE psum; normal exactly TWO (the mid
    λ-reduction the adjoint needs, then one fused full-mesh psum — not one
    per channel-slot, and not separate per-axis reductions)."""
    model, setup = tiny_model
    n = len(jax.devices())
    sh = ShardedSpectro2D(model, make_mesh_2d(2, n // 2))
    x = jnp.asarray(setup["maps"], model.dtype)
    assert_comm(sh._forward_sm, (x,), 1, "mesh2d forward")
    assert_comm(sh._normal_sm, (x,), 2, "mesh2d normal")
