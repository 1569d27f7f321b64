"""Camera and ray math (counterpart of psnerf_tpu/core/rays.py).

Stage-2 pixel -> ray: lift through the full intrinsics (fx, fy, cx, cy),
rotate by pose[:3, :3], L2-normalize. Poses are OpenCV-convention c2w.
"""

from __future__ import annotations

import torch


def lift(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
         intrinsics: torch.Tensor) -> torch.Tensor:
    """Pixel -> camera-space homogeneous point [..., 4]."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x_lift = (x - cx) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [*, 4] (w, x, y, z) -> rotation matrix [*, 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (qj**2 + qk**2), 2 * (qj * qi - qk * qr), 2 * (qi * qk + qr * qj),
        2 * (qj * qi + qk * qr), 1 - 2 * (qi**2 + qk**2), 2 * (qj * qk - qi * qr),
        2 * (qk * qi - qj * qr), 2 * (qj * qk + qi * qr), 1 - 2 * (qi**2 + qj**2),
    ], dim=-1)
    return r.reshape(*q.shape[:-1], 3, 3)


def pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """A [4, 4] c2w matrix passes through; a [7] quaternion+translation
    (w, x, y, z, tx, ty, tz) becomes [4, 4]."""
    if pose.shape[-1] == 7:
        m = torch.eye(4, dtype=pose.dtype, device=pose.device)
        m[:3, :3] = quat_to_rot(pose[..., :4])
        m[:3, 3] = pose[..., 4:]
        return m
    return pose


def get_camera_params(uv: torch.Tensor, pose: torch.Tensor,
                      intrinsics: torch.Tensor):
    """Unit ray directions [N, 3] and camera location [3] from pixel coords
    uv [N, 2], a c2w pose ([4, 4] or [7]) and intrinsics [3|4, 3|4]."""
    pose = pose_to_matrix(pose)
    cam_loc = pose[:3, 3]
    z = torch.ones_like(uv[..., 0])
    pix_cam = lift(uv[..., 0], uv[..., 1], z, intrinsics)
    ray_dirs = torch.einsum("ij,nj->ni", pose[:3, :3], pix_cam[..., :3])
    ray_dirs = ray_dirs / torch.linalg.norm(ray_dirs, dim=-1, keepdim=True)
    return ray_dirs, cam_loc
