"""End-to-end demo of the port: one coarsening step of the reference's
demo workload, headless (the port's run of ``examples/demo.py``).

5,000 random surface samples on a cube, scaled to a unit box, their
kNN graph (k = 32), Poisson disc sampling at ratio 2, parents, coarse
graph, coarse placement, Voronoi triangles and the barycentric
prolongation, then the projection check: U times the coarse points
lies near the fine points.  It prints the counts of each stage and
writes the fine, coarse and projected point clouds as OBJ files.

    python -m gravomg_tpu_torch.demo [out_dir] [device]

``device`` defaults to the card (``cpu`` runs it on the CPU).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.geometry.meshes import cube_mesh, random_points_on_mesh
from gravomg_tpu_torch.io.meshio import write_obj
from gravomg_tpu_torch.utils.device import resolve_device

NUM_POINTS = 5000
REDUCTION_RATIO = 2.0
K = 32


def main(out_dir: str = "demo_out", device=None) -> dict:
    """Runs the demo on ``device`` (the card unless it names another)
    and returns the counts it printed."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    verts, faces = cube_mesh()
    print(f"Loaded cube mesh: {len(verts)}v, {len(faces)}f")

    fine = random_points_on_mesh(NUM_POINTS, verts, faces, seed=0)
    fine = gt.scale_mesh(torch.as_tensor(fine, device=dev)).cpu().numpy()
    print(f"Sampled point cloud: {fine.shape[0]}x3")

    graph = gt.knn_graph(torch.as_tensor(fine, dtype=torch.float32,
                                         device=dev), k=K)
    out = {"max_degree": int(graph.degrees.max())}
    print(f"Produced edge graph: {graph.num_vertices} vertices, "
          f"max degree {out['max_degree']}")

    out["radius"] = float(gt.sampling_radius(graph, REDUCTION_RATIO))
    print(f"Selected radius for fast disc sampling: {out['radius']:.6f}")

    ld = gt.coarsen_once(graph, gt.MultigridConfig(
        reduction_ratio=REDUCTION_RATIO))
    st = ld.stats
    out.update(n_coarse=st.n_coarse,
               coarse_edges=int(ld.coarse.num_edges),
               n_triangles=st.n_triangles, triangle_hits=st.triangle_hits,
               edge_fallbacks=st.edge_fallbacks,
               point_fallbacks=st.point_fallbacks)
    print(f"Selected coarse points using fast disc sampling: {st.n_coarse}")
    print("Associated each fine point with a coarse \"parent\"")
    print(f"Found {out['coarse_edges']} coarse edges based on associated "
          f"fine edges")
    print("Moved each coarse point to the mean of its \"children\"")
    print(f"Constructed {st.n_triangles} voronoi triangles from the coarse "
          f"points")
    print(f"Produced a prolongation operator: {ld.u.n_fine}x{ld.u.n_coarse} "
          f"(hits/edge/point fallbacks: {st.triangle_hits}/"
          f"{st.edge_fallbacks}/{st.point_fallbacks})")

    projected = gt.projected_points(ld.u, ld.coarse.points).cpu().numpy()
    res = np.linalg.norm(projected - fine, axis=1)
    out["max_residual"] = float(res.max())
    print(f"Projection sanity check: max residual {res.max():.4f} "
          f"(sampling radius {out['radius']:.4f})")

    write_obj(os.path.join(out_dir, "fine.obj"), fine)
    write_obj(os.path.join(out_dir, "coarse.obj"),
              ld.coarse.points.cpu().numpy())
    write_obj(os.path.join(out_dir, "projected.obj"), projected)
    print(f"Wrote fine/coarse/projected point clouds to {out_dir}/")
    return out


if __name__ == "__main__":
    main(*sys.argv[1:3])
