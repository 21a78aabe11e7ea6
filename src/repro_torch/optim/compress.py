"""Gradient compression for the cross-pod reduction: per-tensor symmetric
int8 with error feedback (the port of ``repro.optim.compress``).

``make_ef_int8_pod_reduce(mesh)`` is the reduction over the mesh's
``pod`` dimension: each rank compresses its pod's gradient, and the int8
payloads (summed as int32, so the sum is exact in any order), the scales
and the pod count are all-reduced over that dimension only.
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


def make_ef_int8_pod_reduce(mesh):
    """Cross-pod mean of per-pod gradients with int8 + error feedback.

    ``mesh`` is a ``DeviceMesh`` with a ``pod`` dimension.  Returns
    ``reduce_fn(g, error) -> (mean, new_error)`` for plain tensors that
    are the same within a pod and differ across pods (the reference's
    replicated in / out specs): ``ef_compress`` on each rank, then three
    all-reduces over ``pod``: the int32 sum of ``q``, the sum of the
    scales and the pod count; ``mean = qsum * (ssum / npod) / npod`` in
    ``g``'s dtype.
    """
    import torch.distributed as dist
    assert "pod" in mesh.mesh_dim_names
    group = mesh.get_group("pod")

    def reduce_fn(g, error):
        q, scale, new_error = ef_compress(g, error)
        qsum = q.to(torch.int32)
        ssum = scale.clone()                # scales ~equal: the mean scale
        npod = torch.ones((), dtype=torch.float32, device=g.device)
        for t in (qsum, ssum, npod):
            dist.all_reduce(t, group=group)
        mean = qsum.to(torch.float32) * (ssum / npod) / npod
        return mean.to(g.dtype), new_error

    return reduce_fn
