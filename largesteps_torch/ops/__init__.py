"""Mesh operations: procedural shapes, welding, normals."""
