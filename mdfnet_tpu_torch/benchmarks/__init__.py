"""Benchmark metrics of the port: DTU Acc/Comp/Overall (the Python
replacement for the reference's MATLAB pipeline; host code)."""

from mdfnet_tpu_torch.benchmarks.dtu_metric import (
    reduce_points, nn_distances, evaluate_scan, evaluate_dtu)
