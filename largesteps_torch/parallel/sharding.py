"""The layout of a sharded render over the ``(dp, sp)`` mesh of ranks.

Port of ``largesteps_tpu/parallel/sharding.py``.  Vertices, faces, the
parameters, the optimizer state and the solver stay replicated on every
rank; what is sharded is the per-camera work (``mvps``, backgrounds,
reference images, the rasterizer's planes):

* tile pipes with row shards: where ``sp > 1`` and the image's tile rows
  divide by ``sp``, rank ``(d, s)`` renders camera block ``d`` of ``dp``
  and tile-row block ``s`` of ``sp`` of each of those cameras; the
  antialias pass swaps one-row halos along the mesh row
  (:mod:`largesteps_torch.render.pipeline`);
* tile pipes otherwise (the fallback): camera block ``r`` of ``dp · sp``
  on rank ``r``, whole images;
* the dense renderer: camera blocks over all ``dp · sp`` ranks too.  JAX's
  GSPMD shards the dense renderer's image rows on ``sp``; the port shards
  its cameras instead (the same images and gradients), and raises where
  they do not divide.

The image loss is a mean over every rank's pixels, and the gradients of
the renderer's replicated inputs are summed over the ranks
(:meth:`largesteps_torch.render.renderer.Renderer.render`): the port's form
of ``shard_map``'s ``psum`` of replicated cotangents.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..render.kernels import TILE_H
from .distributed import Mesh, all_gather, global_mesh

__all__ = ["make_mesh", "shard_layout", "shard_renderer", "gather_images"]


def make_mesh(dp: int | None = None, sp: int = 1) -> Mesh:
    """The ``(dp, sp)`` mesh over the initialized process group, which must
    hold ``dp · sp`` ranks (``dp`` defaults to the ranks over ``sp``)."""
    if not dist.is_initialized():
        raise RuntimeError("sharding needs an initialized process group "
                           "(largesteps_torch.parallel.distributed."
                           "init_distributed or launch)")
    world = dist.get_world_size()
    dp = world // sp if dp is None else int(dp)
    if dp * sp != world:
        raise RuntimeError(f"sharding dp={dp} x sp={sp} needs {dp * sp} "
                           f"ranks; the process group has {world}")
    return global_mesh(sp)


def shard_layout(n_cams: int, res, backend: str, mesh: Mesh):
    """(row_shards, camera slice, row slice) of this rank: the rule of the
    module's note.  Raises where the cameras do not divide."""
    sp = mesh.sp
    ty_full = res[0] // TILE_H
    rows = (backend == "tiles" and sp > 1 and ty_full % sp == 0
            and ty_full >= sp)
    blocks, block = (mesh.dp, mesh.dp_index) if rows \
        else (mesh.size, mesh.rank)
    if n_cams % blocks:
        raise ValueError(f"cameras ({n_cams}) must divide {blocks}")
    per = n_cams // blocks
    cams = slice(block * per, (block + 1) * per)
    if not rows:
        return 1, cams, slice(0, res[0])
    h = res[0] // sp
    return sp, cams, slice(mesh.sp_index * h, (mesh.sp_index + 1) * h)


def shard_renderer(renderer, mesh: Mesh):
    """Cut a Renderer's per-camera constants to this rank's shard in place
    and attach the mesh, so that ``render`` draws the rank's cameras (and
    rows) and sums its inputs' gradients over the ranks.  Sets
    ``row_shards``, ``cam_slice`` and ``row_slice`` (of the whole
    images)."""
    n_cams = renderer.mvps.shape[0]
    rs, cams, rows = shard_layout(n_cams, renderer.res, renderer.backend,
                                  mesh)
    renderer.mvps = renderer.mvps[cams].contiguous()
    renderer.bgs = renderer.bgs[cams, rows].contiguous()
    renderer.mesh = mesh
    renderer.row_shards = rs
    renderer.cam_slice, renderer.row_slice = cams, rows
    return renderer


def gather_images(local: torch.Tensor, renderer) -> np.ndarray:
    """Every rank's (C/blocks, H/row_shards, W, D) images assembled into the
    whole (C, H, W, D) on every rank (host numpy)."""
    parts = [p.cpu().numpy() for p in all_gather(local.contiguous())]
    mesh = renderer.mesh
    if renderer.row_shards == 1:
        return np.concatenate(parts, axis=0)
    blocks = [np.concatenate(parts[d * mesh.sp:(d + 1) * mesh.sp], axis=1)
              for d in range(mesh.dp)]
    return np.concatenate(blocks, axis=0)
