"""3D math on tensors: rotations, SE(3) transforms, camera geometry, crops,
pose init/update and SO(3) grids."""
