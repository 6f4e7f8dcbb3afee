"""Mesh stack of the port: structured and unstructured marching tets, the
tile rasterizer, the multi-view renderer and UV bake, texture sampling,
TSDF fusion, and the host-side mesh container."""
from .rasterize import (RasterConfig, interpolate, project_mesh, rasterize,
                        render_mesh_attrs)
from .container import Mesh
from .renderer import (bake_texture, camera_weights_uv, pose_to_w2c,
                       render_views, vertex_normals)
from .dmtet import (TetGrid, build_grid_tets, marching_tets,
                    marching_tets_compact)
from .structured_tets import (StructuredTetGrid, marching_tets_structured,
                              marching_tets_topology, marching_tets_verts)
from .texture import (bake_multiview, build_mipmaps, sample_texture,
                      uv_screen_derivatives)
from .tsdf import tsdf_integrate, tsdf_rgbd_to_mesh, tsdf_to_mesh

__all__ = ["RasterConfig", "project_mesh", "rasterize", "interpolate",
           "render_mesh_attrs", "vertex_normals", "pose_to_w2c",
           "render_views", "bake_texture",
           "camera_weights_uv", "build_mipmaps", "sample_texture",
           "uv_screen_derivatives", "bake_multiview", "Mesh",
           "StructuredTetGrid", "marching_tets_structured",
           "marching_tets_topology", "marching_tets_verts", "TetGrid",
           "build_grid_tets", "marching_tets", "marching_tets_compact",
           "tsdf_integrate", "tsdf_to_mesh", "tsdf_rgbd_to_mesh"]
