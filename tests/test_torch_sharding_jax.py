"""The port's sharded paths against the JAX package's, on the CPU.

The JAX side runs on ``tests/conftest.py``'s 8 virtual CPU devices, its
Pallas kernels in interpret mode, as ``tests/test_sharding.py`` runs them;
the port's side in 4 gloo ranks, with the rank bodies of
``tests/test_torch_sharding.py`` (which imports no JAX, so the spawned
ranks do not either).  One launch of the ranks runs the port's side of
the driver and tri-shard checks while this process runs JAX's.

* The driver, ``{"sharding": {"dp": 2, "sp": 2}}``, 2 steps of
  ``test_sharding.py:_driver_run``'s scene, at (64, 128) (tile rows on sp,
  antialias halos), at (32, 32) (the dense renderer: JAX shards its rows
  by GSPMD, the port its cameras) and with ``test_sharding.py:67-81``'s
  big-pipe parameters (host bins, the camera-sequential pipe).  Bars:
  JAX's own (``test_sharding.py:59-62``), losses rtol 1e-3 (atol 2e-6)
  and final vertices atol 2e-3.
* The edge-sharded matvec and CG and the vertex-sharded gather
  (``test_tri_shard.py``'s system: icosphere-3, λ = 19) against JAX's on
  a dp = 2 × sp = 2 mesh, to 1e-5.
* The antialias kernels' plain versions with halo rows, shard by shard,
  against ``aa_fwd_pallas`` and ``aa_bwd_pallas`` with ``halo`` under
  ``shard_map``: 1 camera of 64 × 128 in 2 row shards.  Images 1e-5
  absolute, per-slot sums 1e-4 × max (the JAX kernels reduce with a bf16
  split).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from largesteps_tpu.core.geometry import compute_matrix as j_compute_matrix
from largesteps_tpu.core.parameterize import to_differential as j_to_diff
from largesteps_tpu.driver import optimize_shape as j_optimize_shape
from largesteps_tpu.io.synth import make_scene as j_make_scene
from largesteps_tpu.ops.shapes import icosphere as j_icosphere
from largesteps_tpu.parallel.sharding import make_mesh as j_make_mesh
from largesteps_tpu.parallel.tri_shard import (
    sharded_cg_solve as j_sharded_cg_solve,
    sharded_coo_matvec as j_sharded_coo_matvec,
    sharded_vertex_gather as j_sharded_vertex_gather)
from largesteps_tpu.render import pallas_core as pc
from largesteps_tpu.render.antialias import face_adjacency
from largesteps_tpu.render.camera import project as j_project
from largesteps_tpu.render.renderer import Renderer as JRenderer

from largesteps_torch.render import kernels as K

from test_torch_sharding import launch_meanwhile, parity_rank, vertex_table

T = lambda a: torch.as_tensor(np.array(a))
BIG = {"host_bin_faces": 1, "host_bin_cap": 1152, "rebin_every": 0,
       "rebin_auto": False}
RUNS = {"rows": ((64, 128), {}), "dense": ((32, 32), {}),
        "big": ((64, 128), BIG)}
SHARDING = {"dp": 2, "sp": 2}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this module (beside the suite's other test
    processes, many small operations crawl on more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(res):
    s = j_make_scene(source=("icosphere", 2), target=("gourd", 2),
                     n_views=8, res=32)
    s["res_y"], s["res_x"] = res
    return s


def _params(extra):
    return {"steps": 2, "step_size": 0.05, "lambda": 9.0, "boost": 3,
            "solver": "CG", "sharding": SHARDING, **extra}


def _jax_tri():
    v, f = j_icosphere(3)
    M = j_compute_matrix(v, f, lambda_=19.0)
    u = j_to_diff(M, jnp.asarray(v))
    mesh = j_make_mesh(4, sp=2)
    table, inc = vertex_table(np.asarray(f), u.shape[0])
    want = {"matvec": j_sharded_coo_matvec(M, u, mesh),
            "cg": j_sharded_cg_solve(M, u, mesh, tol=1e-6),
            "gather": j_sharded_vertex_gather(jnp.asarray(table.numpy()),
                                              inc, mesh)}
    return {k: np.asarray(x) for k, x in want.items()}


@pytest.fixture(scope="module")
def parity():
    """(the port's 4 ranks' results, JAX's driver runs, JAX's tri-shard
    results)."""
    runs = [(name, _scene(res), _params(extra), name == "big")
            for name, (res, extra) in RUNS.items()]
    port, (jax_runs, jax_tri) = launch_meanwhile(
        parity_rank, 4, (runs,), lambda: (
            {name: j_optimize_shape(_scene(res), _params(extra))
             for name, (res, extra) in RUNS.items()}, _jax_tri()))
    return port, jax_runs, jax_tri


@pytest.fixture(scope="module")
def drivers(parity):
    return [r["drivers"] for r in parity[0]], parity[1]


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_driver_matches_jax(drivers, name):
    port, jax_runs = drivers
    want = jax_runs[name]
    for rank in port:
        got = rank[name]
        np.testing.assert_array_equal(got["v_final"],
                                      port[0][name]["v_final"])
        np.testing.assert_allclose(got["losses"][:, 0], want["losses"][:, 0],
                                   rtol=1e-3, atol=2e-6)
        np.testing.assert_allclose(got["v_final"], want["v_final"], rtol=0,
                                   atol=2e-3)
    assert port[0][name]["sharding"]["row_shards"] == \
        (2 if name != "dense" else 1)


@pytest.fixture(scope="module")
def tri(parity):
    return [r["tri"] for r in parity[0]], parity[2]


@pytest.mark.parametrize("op", ["matvec", "cg", "gather"])
def test_tri_shard_matches_jax(tri, op):
    port, want = tri
    for rank in port:
        np.testing.assert_allclose(rank[op], want[op],
                                   atol=1e-5 * max(1.0, np.abs(want[op])
                                                   .max()))


H, W, CAP, SP = 64, 128, 256, 2


@pytest.fixture(scope="module")
def halo_case():
    """JAX records, bins and planes of 1 camera at 64 × 128, and the JAX
    antialias kernels under shard_map over 2 row shards."""
    scene = j_make_scene(source=("icosphere", 2), target=("gourd", 2),
                         n_views=1, res=64)
    scene["res_y"], scene["res_x"] = H, W
    v = jnp.asarray(scene["mesh-source"]["vertices"])
    f = np.asarray(scene["mesh-source"]["faces"], np.int32)
    v_ndc = j_project(v, JRenderer(scene, backend="xla").mvps)
    rng = np.random.default_rng(0)
    attrs = rng.normal(size=(v.shape[0], 3)).astype(np.float32)
    rfb, rbb, bins, counts = pc._setup_and_bin(
        v_ndc, jnp.asarray(f), jnp.asarray(attrs),
        jnp.asarray(face_adjacency(f)), H, W, CAP)
    outs = pc.raster_fwd_pallas(rfb, counts, (H, W), CAP, chunk=128)
    fid, z = outs[3], outs[2]
    col = jnp.stack(outs[5:8], -1)
    cov = (fid > 0)[..., None]
    comp = jnp.where(cov, jnp.concatenate([col, cov.astype(col.dtype)], -1),
                     jnp.asarray(rng.uniform(size=(1, H, W, 4)),
                                 jnp.float32))
    g = jnp.asarray(rng.normal(size=(1, H, W, 4)), jnp.float32)
    mesh = Mesh(np.asarray(jax.devices()[:SP]), ("sp",))
    tyl = H // pc.TILE_H // SP
    rows = P(None, "sp")

    def row0():
        return jnp.reshape(jax.lax.axis_index("sp") * tyl, (1,)) \
            .astype(jnp.int32)

    fwd = jax.shard_map(
        lambda r, c, a, b, d: pc.aa_fwd_pallas(
            r, c, a, b, d, (H, W), CAP, D=4, row0=row0(), halo=("sp", SP)),
        mesh=mesh, in_specs=(rows,) * 5, out_specs=rows, check_vma=False)
    bwd = jax.shard_map(
        lambda r, c, a, b, d, e: pc.aa_bwd_pallas(
            r, c, a, b, d, e, (H, W), CAP, D=4, row0=row0(),
            halo=("sp", SP)),
        mesh=mesh, in_specs=(rows,) * 6, out_specs=(rows, rows),
        check_vma=False)
    planes = dict(rbb=rbb, counts=counts, fid=fid, z=z, comp=comp, g=g)
    want = {"out": fwd(rbb, counts, fid, z, comp),
            "bwd": bwd(rbb, counts, fid, z, comp, g)}
    return ({k: T(x) for k, x in planes.items()},
            jax.tree.map(np.asarray, want))


def _plain_shards(p, direction):
    """The plain version shard by shard with its halo rows, each shard's
    share added to the next shard's row 0, the rows concatenated."""
    hl, tyl = H // SP, H // pc.TILE_H // SP
    outs, shares, slots = [], [], []
    for s in range(SP):
        rows = slice(s * hl, (s + 1) * hl)
        tiles = slice(s * tyl, (s + 1) * tyl)
        nxt = rows.stop - 1 if s == SP - 1 else rows.stop
        halo = (p["fid"][:, nxt], p["z"][:, nxt], p["comp"][:, nxt])
        args = (p["rbb"][:, tiles], p["counts"][:, tiles], p["fid"][:, rows],
                p["z"][:, rows], p["comp"][:, rows])
        if direction == "fwd":
            out, share = K.aa_fwd_plain(*args, (H, W), s * tyl, halo)
        else:
            out, dslot, share = K.aa_bwd_plain(
                *args, p["g"][:, rows], (H, W), s * tyl,
                halo + (p["g"][:, nxt],))
            slots.append(dslot)
        if s > 0:
            out[:, 0] += shares[-1]
        outs.append(out)
        shares.append(share)
    return torch.cat(outs, 1).numpy(), \
        (torch.cat(slots, 1).numpy() if slots else None)


def test_halo_aa_fwd_plain_matches_pallas(halo_case):
    planes, want = halo_case
    got, _ = _plain_shards(planes, "fwd")
    np.testing.assert_allclose(got, want["out"], atol=1e-5)


def test_halo_aa_bwd_plain_matches_pallas(halo_case):
    planes, want = halo_case
    got, dslot = _plain_shards(planes, "bwd")
    d_want, s_want = want["bwd"]
    np.testing.assert_allclose(got, d_want, atol=1e-5)
    np.testing.assert_allclose(dslot[..., :6], s_want[..., :6],
                               atol=1e-4 * np.abs(s_want).max())
