"""Parallelism over a mesh of devices: the mesh itself (sequence-parallel
attention lives in `ops.ring_attention`)."""

from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
