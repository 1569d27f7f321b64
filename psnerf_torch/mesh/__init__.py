"""Mesh extraction of the stage-1 field (counterpart of psnerf_tpu/mesh):
the native MISE octree, isosurfacer and BVH (csrc/, built by build.py), the
extraction loop, mesh I/O, Chamfer distances, vertex refinement and
silhouette carving."""
