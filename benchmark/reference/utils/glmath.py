"""GLM-compatible matrix math (host side, NumPy).

The reference engine does all of its camera / light matrix math on the CPU
with GLM compiled with ``GLM_FORCE_DEPTH_ZERO_TO_ONE``
(reference: src/CMakeLists.txt:24), so ``glm::perspective`` / ``glm::ortho`` /
``glm::lookAt`` resolve to their RH_ZO variants.  This module reproduces the
exact formulas so that view/projection/light matrices match bit-for-bit
(modulo float associativity).

Convention: matrices here are standard row-major math matrices ``M[row, col]``
acting on column vectors (``clip = M @ v``).  GLM stores column-major
(``m[col][row]``); formulas below are transcribed accordingly.  All functions
return ``float32`` ``np.ndarray``.
"""

from __future__ import annotations

import numpy as np

Vec3 = np.ndarray
Mat4 = np.ndarray


def vec3(x, y=None, z=None) -> Vec3:
    if y is None:
        return np.array([x, x, x], dtype=np.float32)
    return np.array([x, y, z], dtype=np.float32)


def vec4(x, y=None, z=None, w=None) -> np.ndarray:
    if y is None:
        return np.array([x, x, x, x], dtype=np.float32)
    return np.array([x, y, z, w], dtype=np.float32)


def identity() -> Mat4:
    return np.eye(4, dtype=np.float32)


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def translate(t: Vec3) -> Mat4:
    m = identity()
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def scale(s: Vec3) -> Mat4:
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(s, dtype=np.float32)
    return m


def rotate_x(angle: float) -> Mat4:
    """Rotation about +X (glm::angleAxis(angle, (1,0,0)))."""
    c, s = np.cos(angle), np.sin(angle)
    m = identity()
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rotate_y(angle: float) -> Mat4:
    """Rotation about +Y (glm::angleAxis(angle, (0,1,0)))."""
    c, s = np.cos(angle), np.sin(angle)
    m = identity()
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def perspective_rh_zo(fovy_rad: float, aspect: float, z_near: float, z_far: float) -> Mat4:
    """glm::perspectiveRH_ZO — right-handed, depth 0..1.

    Matches glm/ext/matrix_clip_space.inl perspectiveRH_ZO:
      m[0][0] = 1/(aspect*tanHalf); m[1][1] = 1/tanHalf;
      m[2][2] = zFar/(zNear-zFar);  m[2][3] = -1;
      m[3][2] = -(zFar*zNear)/(zFar-zNear)
    (glm is m[col][row]).
    """
    tan_half = np.tan(np.float32(fovy_rad) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = z_far / (z_near - z_far)
    m[3, 2] = -1.0
    m[2, 3] = -(z_far * z_near) / (z_far - z_near)
    return m


def ortho_rh_zo(left: float, right: float, bottom: float, top: float,
                z_near: float, z_far: float) -> Mat4:
    """glm::orthoRH_ZO (what glm::ortho resolves to under FORCE_DEPTH_ZERO_TO_ONE)."""
    m = identity()
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -1.0 / (z_far - z_near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -z_near / (z_far - z_near)
    return m


def look_at_rh(eye: Vec3, center: Vec3, up: Vec3) -> Mat4:
    """glm::lookAtRH (glm default for right-handed builds)."""
    eye = np.asarray(eye, dtype=np.float32)
    f = normalize(np.asarray(center, dtype=np.float32) - eye)
    s = normalize(np.cross(f, np.asarray(up, dtype=np.float32)))
    u = np.cross(s, f)
    m = identity()
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def inverse(m: Mat4) -> Mat4:
    return np.linalg.inv(m).astype(np.float32)



def extract_frustum_planes(view_proj: Mat4) -> np.ndarray:
    """Gribb-Hartmann frustum plane extraction, normalized.

    Matches reference src/vk_engine_run.cpp:420-433 (note glm's M[i] is a
    column; transposed there, so rows of ``view_proj`` here).
    Returns [6, 4] planes (nx, ny, nz, d); point inside when dot+d >= -r.
    """
    m = np.asarray(view_proj, dtype=np.float32)
    planes = np.stack([
        m[3] + m[0],   # left
        m[3] - m[0],   # right
        m[3] + m[1],   # bottom
        m[3] - m[1],   # top
        m[2],          # near   (z >= 0 in ZO clip)
        m[3] - m[2],   # far
    ])
    lengths = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
    return (planes / lengths).astype(np.float32)
