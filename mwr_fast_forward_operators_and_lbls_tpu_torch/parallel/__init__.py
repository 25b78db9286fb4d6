"""Profiling and roofline accounting of the port's kernels."""
