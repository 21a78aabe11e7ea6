"""Gradient compression for the cross-pod reduction: per-tensor symmetric
int8 with error feedback (the port's ``repro.optim.compress``, its pure
functions).

``make_ef_int8_pod_reduce``, the reduction itself over the production
mesh's ``pod`` axis, waits for ``parallel/`` (ROADMAP Queue A).
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: returns (q, scale), scale a 0-d float32
    tensor."""
    xf = x.to(torch.float32)
    amax = torch.max(torch.abs(xf))
    scale = torch.maximum(amax, torch.full_like(amax, 1e-12)) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(g: torch.Tensor, error: torch.Tensor):
    """Error-feedback compress: returns (q, scale, new_error)."""
    corrected = g.to(torch.float32) + error
    q, scale = quantize_int8(corrected)
    new_error = corrected - dequantize_int8(q, scale)
    return q, scale, new_error
