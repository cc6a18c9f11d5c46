"""Closed forms, the composition layer, the exact-trace scheduler and the
conformance harness of the port."""
