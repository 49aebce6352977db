"""FPS camera with the exact semantics of the reference Camera class.

Reference: src/vk_camera.h:6-25, src/vk_camera.cpp:6-54.
- view = inverse(translate(position) @ R_yaw @ R_pitch)
- proj = perspectiveRH_ZO(radians(fov), aspect, zNear, zFar) with
  proj[1][1] *= -1 (GL y-up -> Vulkan y-down)
- update: position += mat3(R) @ velocity * dt * 5
- mouse drag: yaw -= dx/200, pitch -= dy/200
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import glmath as glm


@dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    pitch: float = 0.0
    yaw: float = 0.0
    fov: float = 60.0      # degrees
    z_near: float = 0.1
    z_far: float = 100.0

    def process_mouse(self, dx: float, dy: float) -> None:
        """Middle-mouse-drag look (vk_camera.cpp:6-14)."""
        self.yaw -= dx / 200.0
        self.pitch -= dy / 200.0

    def process_keys(self, w=False, s=False, a=False, d=False) -> None:
        """WASD velocity (vk_camera.cpp:16-24)."""
        v = np.zeros(3, dtype=np.float32)
        if w: v[2] -= 1.0
        if s: v[2] += 1.0
        if a: v[0] -= 1.0
        if d: v[0] += 1.0
        self.velocity = v

    def update(self, dt: float) -> None:
        """vk_camera.cpp:26-31 — move in camera space at 5 units/s."""
        rot = self.rotation_matrix()
        self.position = (self.position + (rot[:3, :3] @ self.velocity) * dt * 5.0).astype(np.float32)

    def rotation_matrix(self) -> np.ndarray:
        """R_yaw(about +Y) @ R_pitch(about +X) (vk_camera.cpp:40-46)."""
        return (glm.rotate_y(self.yaw) @ glm.rotate_x(self.pitch)).astype(np.float32)

    def view_matrix(self) -> np.ndarray:
        """inverse(T(position) @ R) (vk_camera.cpp:33-38)."""
        return glm.inverse(glm.translate(self.position) @ self.rotation_matrix())

    def projection_matrix(self, aspect: float) -> np.ndarray:
        """perspectiveRH_ZO with the Vulkan y-flip (vk_camera.cpp:48-54)."""
        proj = glm.perspective_rh_zo(np.radians(self.fov), aspect, self.z_near, self.z_far)
        proj[1, 1] *= -1.0
        return proj
