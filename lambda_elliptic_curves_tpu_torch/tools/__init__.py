"""Measurement scripts of the port, run by hand on a card (``python3 -m
lambda_elliptic_curves_tpu_torch.tools.<name>``)."""
