"""Geometry, matching, NMS, preprocessing, the fused conv op and int8 quantization.

Importing this package builds no kernel and imports neither nvcc's output nor triton;
each CUDA kernel is compiled at its first launch (ops/_cuda_build.py).
"""
