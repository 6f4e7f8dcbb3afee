"""Mesh stack of the port: structured marching tets, the tile rasterizer,
the multi-view renderer and UV bake, and the host-side mesh container."""
from .rasterize import RasterConfig, interpolate, project_mesh, rasterize
from .container import Mesh
from .renderer import (bake_texture, pose_to_w2c, render_views,
                       vertex_normals)
from .structured_tets import (StructuredTetGrid, marching_tets_structured,
                              marching_tets_topology, marching_tets_verts)

__all__ = ["RasterConfig", "project_mesh", "rasterize", "interpolate",
           "vertex_normals", "pose_to_w2c", "render_views", "bake_texture",
           "Mesh",
           "StructuredTetGrid", "marching_tets_structured",
           "marching_tets_topology", "marching_tets_verts"]
