"""Meshes: the host-side `Mesh` type, procedural test meshes and the padded
mesh database."""
