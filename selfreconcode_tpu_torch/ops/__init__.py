"""Geometry ops: binning, splat soft mask and its kernels, trilinear lookup, octree sweep, marching cubes."""
