"""Launchers: the host and production meshes, and the serve / train CLIs."""

from .mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
