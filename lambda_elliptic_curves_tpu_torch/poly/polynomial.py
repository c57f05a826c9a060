"""Tensor helpers of ``lambda_elliptic_curves_tpu/poly/polynomial.py``
(only ``field_sum`` so far; the host ``Polynomial`` class is ROADMAP
queue 1 item 8)."""

from __future__ import annotations

import torch


def field_sum(field, arr, axis=-1):
    """Modular sum along ``axis`` by log-depth halving (every step one
    full-width field add; ``torch.sum`` cannot be used because the
    reduction must be modular)."""
    arr = torch.movedim(arr, axis, -1)
    n = arr.shape[-1]
    while n > 1:
        half = n // 2
        s = field.add(arr[..., :half], arr[..., half:2 * half])
        if n % 2:
            s = torch.cat([s, arr[..., -1:]], dim=-1)
        arr = s
        n = arr.shape[-1]
    return arr[..., 0]
