"""Sharding of the phase step over a mesh of devices: the mesh, the halo
exchanges and the lane-sharded (W-axis) Riesz step."""
