"""Interactive viewer socket protocol, wire-compatible with the 3DGS GUI
(counterpart of f3d_gaus_tpu/utils/network_gui.py, a numpy copy: that
package's import chain pulls in JAX).

The reference's network_gui (gaussian_renderer/network_gui.py:26-85)
framing, so SIBR / the stock 3DGS remote viewer can connect:

  request : 4-byte little-endian length + JSON
            {resolution_x/y, train, fov_x/y, z_near/far, shs_python,
             rot_scale_python, keep_alive, scaling_modifier,
             view_matrix[16], view_projection_matrix[16]}
  response: raw RGB bytes (H*W*3, uint8, row-major) followed by
            4-byte little-endian length + ascii verify string

Differences from the reference:
  * no module-level globals: a NetworkGUI object owns the listener, and
    rendering goes through a caller-supplied `render_fn(camera_dict)
    -> (3, H, W) float array in [0, 1]` (train/per_scene.py:_gui_render);
  * the view/projection matrices arrive in the viewer's convention with
    the column flips the reference applies on the GPU
    (network_gui.py:75-78) applied here in numpy before handing the
    camera dict to render_fn.

Poll it from a training loop (the reference's pattern, train.py:52-65):

    gui = NetworkGUI(host, port)
    ...
    gui.poll(render_fn, source_path)   # each iteration; never blocks
"""
from __future__ import annotations

import json
import select
import socket

import numpy as np


def _flip_cols(m, cols):
    m = np.array(m, np.float32, copy=True).reshape(4, 4)
    for c in cols:
        m[:, c] = -m[:, c]
    return m


def parse_request(message: dict):
    """JSON request -> camera dict (or None for the 0x0 keep-alive ping).
    Mirrors network_gui.receive (network_gui.py:57-86): the viewer's
    view matrix gets columns 1 AND 2 negated (:75-76) but the
    view-projection matrix only column 1 (:78)."""
    width = int(message["resolution_x"])
    height = int(message["resolution_y"])
    if width == 0 or height == 0:
        return None
    return {
        "width": width,
        "height": height,
        "fov_x": float(message["fov_x"]),
        "fov_y": float(message["fov_y"]),
        "z_near": float(message["z_near"]),
        "z_far": float(message["z_far"]),
        "train": bool(message["train"]),
        "keep_alive": bool(message["keep_alive"]),
        "scaling_modifier": float(message.get("scaling_modifier", 1.0)),
        "world_view": _flip_cols(message["view_matrix"], (1, 2)),
        "full_proj": _flip_cols(message["view_projection_matrix"], (1,)),
    }


def encode_image(img) -> bytes:
    """(3, H, W) float [0,1] -> interleaved HWC uint8 bytes (the byte
    contract of train.py:57-58's memoryview send)."""
    arr = np.asarray(img)
    arr = np.clip(arr, 0.0, 1.0)
    arr = (arr * 255).astype(np.uint8)
    return np.transpose(arr, (1, 2, 0)).tobytes()


class NetworkGUI:
    """Non-blocking listener; at most one viewer connection at a time."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None

    @property
    def port(self) -> int:
        return self.listener.getsockname()[1]

    def _try_connect(self):
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except OSError:
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer closed")
            buf += chunk
        return buf

    def _read(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _send(self, image_bytes: bytes | None, verify: str):
        if image_bytes:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def poll(self, render_fn, verify: str = "", timeout: float = 0.0) -> bool:
        """Serve at most one pending request; returns True if one was
        served.  render_fn(camera_dict) -> (3, H, W) float image, or the
        request is a keep-alive ping (no image in the reply)."""
        if self.conn is None:
            self._try_connect()
        if self.conn is None:
            return False
        # never block the training loop: read only when a request has
        # started arriving (the reference's receive() blocks; poll must not)
        readable, _, _ = select.select([self.conn], [], [], timeout)
        if not readable:
            return False
        try:
            cam = parse_request(self._read())
            payload = encode_image(render_fn(cam)) if cam else None
            self._send(payload, verify)
            return True
        except Exception:
            # a malformed request or a render failure must never kill the
            # training loop (the reference wraps its GUI block in a broad
            # except and drops the connection, train.py:63-65); the viewer
            # simply reconnects
            try:
                self.conn.close()
            finally:
                self.conn = None
            return False

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self.listener.close()
