"""Meshes: the host-side `Mesh` type, procedural test meshes and the padded
mesh database."""

from happypose_tpu_torch.meshes.io import load_mesh, Mesh
from happypose_tpu_torch.meshes.database import MeshDataBase, BatchedMeshes

__all__ = ["load_mesh", "Mesh", "MeshDataBase", "BatchedMeshes"]
