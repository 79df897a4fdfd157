"""Map operations: insert, collide and sensor carving, with their CUDA kernels."""
