"""Mesh stack of the port: structured marching tets, the tile rasterizer
and the multi-view renderer."""
from .rasterize import RasterConfig, interpolate, project_mesh, rasterize
from .renderer import pose_to_w2c, render_views, vertex_normals
from .structured_tets import (StructuredTetGrid, marching_tets_structured,
                              marching_tets_topology, marching_tets_verts)

__all__ = ["RasterConfig", "project_mesh", "rasterize", "interpolate",
           "vertex_normals", "pose_to_w2c", "render_views",
           "StructuredTetGrid", "marching_tets_structured",
           "marching_tets_topology", "marching_tets_verts"]
