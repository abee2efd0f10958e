"""Distributed scan matching: SPMD Gauss-Newton over a mesh (port of
loc_lib_tpu/parallel/match.py).

The SOURCE points are split over the mesh's "dp" axis (each rank takes
its contiguous block of rows) and the target (hash grid, plane table or
NDT voxel table) is replicated. Each rank linearizes its block with the
port's own kernels and GN loop (`icp._gauss_newton`, `ndt.scan_match`);
one all_reduce SUM of the packed (H, b, count, chi2), 44 floats, per
iteration fuses the global normal equations, and every rank solves the
same 6x6 system, so the pose stays replicated with no other traffic.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models import icp, ndt
from ..ops.pointcloud import PointCloud
from . import mesh as mesh_mod


def psum_terms(mesh: DeviceMesh, axes=("dp", "mp")):
    """The reduction hook of the GN loops: (H, b, count, chi2) summed over
    `axes` in ONE all_reduce of a 44-float buffer (the count travels as a
    float, exact below 2^24). Where `axes` hold one rank it is None and the
    loops take their single-device path."""
    if mesh_mod.group(mesh, axes) is None:
        return None

    def reduce(H, b, n, chi2):
        buf = torch.cat([H.reshape(36), b.reshape(6), n.reshape(1).to(torch.float32),
                         chi2.reshape(1)])
        buf = mesh_mod.psum(buf, mesh, axes)
        return (buf[:36].reshape(6, 6), buf[36:42], buf[42].round().to(torch.int32), buf[43])
    return reduce


def local_cloud(src: PointCloud, mesh: DeviceMesh, axis: str = "dp") -> PointCloud:
    """This rank's block of a replicated cloud's rows over `axis`."""
    return PointCloud(xyz=mesh_mod.local_rows(src.xyz, mesh, axis),
                      mask=mesh_mod.local_rows(src.mask, mesh, axis))


def icp_scan_match(mesh: DeviceMesh, target: icp.IcpTarget, opts: icp.IcpOptions,
                   src: PointCloud, R0, t0) -> icp.MatchResult:
    """Distributed ICP: src rows over "dp", the target replicated."""
    icp._check_method(opts)
    return icp._gauss_newton(icp._TERM_FNS[opts.method], target, opts,
                             local_cloud(src, mesh), R0, t0,
                             reduce=psum_terms(mesh, ("dp",)))


def ndt_scan_match(mesh: DeviceMesh, m: ndt.NdtMap, opts: ndt.NdtOptions, src: PointCloud,
                   R0, t0) -> ndt.MatchResult:
    """Distributed NDT: src rows over "dp", the voxel table replicated. In
    direct mode every source point counts as effective (the reference's
    quirk), and, as in the JAX package, the result's num_effective is then
    the source count over all ranks."""
    local = local_cloud(src, mesh)
    n_points = mesh_mod.psum(local.count(), mesh, "dp")
    res = ndt.scan_match(m, opts, local, R0, t0, reduce=psum_terms(mesh, ("dp",)),
                         n_points=n_points)
    return res if opts.method == "incremental" else res._replace(num_effective=n_points)
