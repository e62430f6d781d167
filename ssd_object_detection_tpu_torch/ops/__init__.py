"""Geometry, matching, NMS, preprocessing and the fused conv op.

Importing this package builds no kernel and imports neither nvcc's output nor triton;
each CUDA kernel is compiled at its first launch (ops/_cuda_build.py).
"""
