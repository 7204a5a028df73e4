"""Acceleration structures: the native BVH build and the wide-node tables."""
