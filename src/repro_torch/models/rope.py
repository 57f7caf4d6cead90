"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

M-RoPE [arXiv:2409.12191] splits the head_dim/2 frequency bands into three
sections (temporal, height, width), each rotated by its own position
stream.  For text-only inputs all three streams equal the sequence index,
which reduces M-RoPE to RoPE exactly.  Angles, cos and sin are fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), ex)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> torch.Tensor:
    """positions: (..., S) -> angles (..., S, head_dim/2)."""
    return positions[..., None].float() * _freqs(head_dim, theta,
                                                 positions.device)


def mrope_angles(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]) -> torch.Tensor:
    """positions3: (B, S, 3) -> angles (B, S, head_dim/2) with the
    frequency bands split into (t, h, w) sections."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {sections} must sum to "
                         f"head_dim/2 = {head_dim // 2}")
    dev = positions3.device
    base = _freqs(head_dim, theta, dev)                       # (hd/2,)
    ang = positions3[..., None, :].float() * base[None, None, :, None]
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=dev), torch.tensor(sections, device=dev),
        output_size=head_dim // 2)
    idx = sec_id[None, None, :, None].expand(*ang.shape[:-1], 1)
    return torch.gather(ang, -1, idx)[..., 0]


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); angles: (B, S, D/2) or (S, D/2)."""
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
