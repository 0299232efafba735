"""The benchmark's harness: traffic, weights, the window, the trace and the check."""
