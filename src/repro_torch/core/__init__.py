"""Closed forms of the port's kernels and the conformance harness."""
