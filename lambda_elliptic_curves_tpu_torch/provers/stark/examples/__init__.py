"""STARK example AIRs (Fibonacci so far)."""
