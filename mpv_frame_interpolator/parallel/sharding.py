"""Device-mesh sharding for the flow search and warp.

The reference is strictly single-GPU (SURVEY.md §2.8: no distributed comm
backend exists); multi-device is this rebuild's scaling extension:

* **Search-layer sharding (flow)**: the delta-sum search evaluates
  `search_radius` independent candidate layers -- the natural tensor-
  parallel axis.  Each device computes its contiguous slice of layers and
  the argmin is resolved with one tiny all_gather of per-window minima
  (shard_map).  First-minimum tie-breaking matches the sequential scan
  of determineLowestLayerKernel.cl:13-18 because layers are distributed in
  ascending blocks.
* **Row sharding (warp)**: outputs are sharded over image rows with
  replicated flow; XLA/GSPMD inserts the halo exchanges for the source
  gathers automatically.

One device remains the product configuration; no CLI, API or bench
entry reaches this module.  It exists for scale-out and for the
multi-device dry run (``__graft_entry__.dryrun_multichip``), and has only
been run on virtual CPU devices.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpv_frame_interpolator.ops import flow as flow_ops
from mpv_frame_interpolator.ops import warp as warp_ops
from mpv_frame_interpolator.ops.flow import FlowGeometry


def make_mesh(devices: Sequence[jax.Device] | None = None,
              axis: str = "layers") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def sharded_flow_fn(geom: FlowGeometry, radius: int, mesh: Mesh,
                    luma_shift: int = 0):
    """Flow search with candidate layers sharded over the mesh axis.

    radius must be divisible by the mesh size; layers [d*R/D, (d+1)*R/D)
    live on device d.  Returns a jitted fn with the same signature as
    ops.flow.make_flow_fn."""
    n_dev = mesh.devices.size
    assert radius % n_dev == 0, (radius, n_dev)
    r_local = radius // n_dev
    lh, lw = geom.low_h, geom.low_w

    from jax import shard_map

    def layer_slice_sums(z0, window, iteration, step, off_x, off_y,
                         f1y, f1u, f1v, f2_probe, ds, nbs):
        """Window delta sums for layers [z0, z0+r_local): the same dense
        computation as _delta_sums_one_step but over a layer slice."""
        rs = geom.res_scalar
        H, W = geom.height, geom.stride
        y2, u2, v2 = f2_probe
        cyg, cxg = jnp.mgrid[0:lh, 0:lw]
        scaled_cx = (cxg << rs).astype(jnp.int32)
        scaled_cy = (cyg << rs).astype(jnp.int32)

        z = z0 + jnp.arange(r_local, dtype=jnp.int32)
        rel = z - radius // 2
        adj = jnp.where(rel > 0, rel * rel, -(rel * rel))[:, None, None]

        if step == 0:
            cand_x = off_x[None] + adj
            cand_y = jnp.broadcast_to(off_y[None], (r_local, lh, lw))
            probe, prev_plane = cand_x, off_x
        else:
            cand_x = jnp.broadcast_to(off_x[None], (r_local, lh, lw))
            cand_y = off_y[None] + adj
            probe, prev_plane = cand_y, off_y

        new_cx = flow_ops.mirror_inside(scaled_cx[None] + cand_x, W)
        new_cy = flow_ops.mirror_inside(scaled_cy[None] + cand_y, H)
        y1 = flow_ops._gather(f1y, new_cy, new_cx).astype(jnp.int32)
        u1 = flow_ops._gather(f1u, new_cy >> 1, new_cx >> 1).astype(jnp.int32)
        v1 = flow_ops._gather(f1v, new_cy >> 1, new_cx >> 1).astype(jnp.int32)
        delta = (jnp.abs(y1 - y2[None]) + jnp.abs(u1 - u2[None])
                 + jnp.abs(v1 - v2[None])).astype(jnp.uint32)
        if luma_shift:
            delta = delta >> np.uint32(luma_shift)
        delta = delta << ds.astype(jnp.uint32)
        bias = jnp.abs(probe).astype(jnp.uint32)
        if iteration >= flow_ops.FIRST_NEIGHBOR_ITERATION:
            w2 = 2 * window
            nb = jnp.zeros((r_local, lh, lw), jnp.uint32)
            for dx, dy in ((0, w2), (w2, 0), (-w2, 0), (0, -w2)):
                nx = np.clip(np.arange(lw) + dx, 0, lw - 1)
                ny = np.clip(np.arange(lh) + dy, 0, lh - 1)
                n_off = prev_plane[jnp.asarray(ny)[:, None],
                                   jnp.asarray(nx)[None, :]]
                nb = nb + jnp.abs(n_off[None] - probe).astype(jnp.uint32)
            bias = bias + (nb << nbs.astype(jnp.uint32))
        partial = delta + bias
        nwy, nwx = -(-lh // window), -(-lw // window)
        if window > 1:
            padded = jnp.zeros((r_local, nwy * window, nwx * window),
                               jnp.uint32)
            padded = padded.at[:, :lh, :lw].set(partial)
            return padded.reshape(r_local, nwy, window, nwx, window).sum(
                axis=(2, 4), dtype=jnp.uint32)
        return partial

    def flow(f1y, f1u, f1v, f2y, f2u, f2v, ds, nbs):
        f2_probe = flow_ops._subsampled_f2(geom, f2y, f2u, f2v)
        off_x = jnp.zeros((lh, lw), jnp.int32)
        off_y = jnp.zeros((lh, lw), jnp.int32)

        for iteration, window in enumerate(geom.window_schedule()):
            for step in (0, 1):
                def shard_body(ox, oy, y1p, u1p, v1p, probes):
                    dev = jax.lax.axis_index("layers")
                    z0 = dev * r_local
                    sums = layer_slice_sums(z0, window, iteration, step,
                                            ox, oy, y1p, u1p, v1p, probes,
                                            ds, nbs)
                    # local first-min over this device's layer block
                    local_arg = jnp.argmin(sums, 0).astype(jnp.uint32)
                    local_min = jnp.min(sums, 0)
                    # global first-min: one tiny all_gather
                    mins = jax.lax.all_gather(local_min, "layers")   # (D,nwy,nwx)
                    args = jax.lax.all_gather(local_arg, "layers")
                    windex = jnp.argmin(mins, 0)
                    nwy, nwx = local_min.shape
                    iy, ix = jnp.mgrid[0:nwy, 0:nwx]
                    winner = (windex.astype(jnp.uint32) * r_local
                              + args[windex, iy, ix])
                    return winner.astype(jnp.int32)

                winner = shard_map(
                    shard_body, mesh=mesh,
                    in_specs=(P(), P(), P(), P(), P(), (P(), P(), P())),
                    out_specs=P(),
                    check_vma=False,
                )(off_x, off_y, f1y, f1u, f1v, f2_probe)

                rel = winner - radius // 2
                adj = jnp.where(rel > 0, rel * rel, -(rel * rel))
                if window > 1:
                    adj = jnp.repeat(jnp.repeat(adj, window, 0), window, 1)
                adj = adj[:lh, :lw]
                if step == 0:
                    off_x = off_x + adj
                else:
                    off_y = off_y + adj

        offset = jnp.stack([off_x, off_y])
        blurred = flow_ops.blur_flow(offset, lh, lw)
        return offset, blurred

    return jax.jit(flow)


def row_sharded_warp_fn(geom: FlowGeometry, mode: int, mesh: Mesh,
                        scale_shift: int = 0, axis: str = "layers"):
    """Warp with outputs sharded over image rows; GSPMD inserts the halo
    collectives for the cross-shard source gathers."""
    base = warp_ops.make_warp_fn(geom, mode, scale_shift)
    row_sharding = NamedSharding(mesh, P(axis, None))

    def step(f1y, f1u, f1v, f2y, f2u, f2v, blurred, t, black, white):
        y, u, v = base(f1y, f1u, f1v, f2y, f2u, f2v, blurred, t, black, white)
        return (jax.lax.with_sharding_constraint(y, row_sharding), u, v)

    return jax.jit(step)


def interp_step_sharded(geom: FlowGeometry, radius: int, mesh: Mesh,
                        mode: int = warp_ops.BLENDED_FRAME,
                        scale_shift: int = 0):
    """Full multi-device step: layer-sharded flow + row-sharded warp."""
    flow_fn = sharded_flow_fn(geom, radius, mesh, scale_shift)
    warp_fn = row_sharded_warp_fn(geom, mode, mesh, scale_shift)

    def step(f1y, f1u, f1v, f2y, f2u, f2v, t, ds, nbs, black, white):
        offset, blurred = flow_fn(f1y, f1u, f1v, f2y, f2u, f2v, ds, nbs)
        y, u, v = warp_fn(f1y, f1u, f1v, f2y, f2u, f2v, blurred,
                          t, black, white)
        return offset, y, u, v

    return step
