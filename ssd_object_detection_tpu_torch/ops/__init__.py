"""Geometry: box math, anchor generation and greedy anchor matching.

Importing this package builds no kernel and imports neither nvcc's output nor triton;
the CUDA matcher is compiled at its first launch (ops/cuda_matcher.py).
"""
