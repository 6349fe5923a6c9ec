"""Camera/video client for the recognition server.

Counterpart of `facerecognitionpipeline_tpu/serve/client.py`, a capability
rebuild of the reference `FaceRecognitionClient`: health-check +
/init_session handshake, frame-skip base64 PNG POSTs to /process_frame (or
raw planes to /process_frame_raw), server track-state mirroring for the HUD
overlay, auto/manual snapshots, SIGINT/SIGTERM graceful finalize with the
client performance report. `--video` file and `--synthetic` frame sources
stand next to the camera, and `--no_display` serves ssh sessions.

HTTP goes through the standard library (`HTTPSession` on `http.client`, one
persistent connection per server), with the headers and bodies the JAX
package's client sends through `requests`. The module imports neither torch
nor cv2: image codecs are looked up at the call (utils/io.py).
"""

from __future__ import annotations

import argparse
import base64
import http.client
import json as _json
import os
import signal
import threading
import time
import urllib.parse
from datetime import datetime
from typing import Dict, Iterator, Optional

import numpy as np

from facerecognitionpipeline_tpu_torch.serve import rawproto
from facerecognitionpipeline_tpu_torch.telemetry.monitor import PerformanceMonitorClient
from facerecognitionpipeline_tpu_torch.utils.io import encode_image_rgb

RESOLUTION_LADDER = [(3840, 2160), (2560, 1440), (1920, 1080), (1280, 720), (640, 480)]


def _encode_image_base64(image_rgb: np.ndarray, image_format: str = "png") -> str:
    """PNG matches the reference payload; 'jpeg' (quality 92) encodes ~10x
    smaller and several times faster — the server decodes either
    transparently."""
    return base64.b64encode(encode_image_rgb(image_rgb, image_format)).decode("utf-8")


class HTTPResponse:
    """What the client reads of a response: status_code, content, text,
    json()."""

    def __init__(self, status_code: int, content: bytes):
        self.status_code = status_code
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self):
        return _json.loads(self.content)


class HTTPSession:
    """Minimal HTTP/1.1 session on `http.client`: `get(url, timeout=)` and
    `post(url, json= | data=, headers=, timeout=)`, one persistent
    connection per (scheme, host, port). A request on a kept-alive
    connection that the server has closed meanwhile is sent once more on a
    fresh connection."""

    _STALE = (
        http.client.RemoteDisconnected, BrokenPipeError, ConnectionResetError,
        http.client.CannotSendRequest, http.client.ResponseNotReady,
    )

    def __init__(self):
        self._conns: Dict = {}
        self._lock = threading.Lock()

    def _request(self, method, url, body, headers, timeout) -> HTTPResponse:
        parts = urllib.parse.urlsplit(url)
        key = (parts.scheme, parts.hostname, parts.port)
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        with self._lock:
            for attempt in (0, 1):
                conn = self._conns.get(key)
                reused = conn is not None
                if conn is None:
                    cls = (
                        http.client.HTTPSConnection
                        if parts.scheme == "https"
                        else http.client.HTTPConnection
                    )
                    conn = self._conns[key] = cls(parts.hostname, parts.port)
                try:
                    conn.timeout = timeout
                    if conn.sock is not None:
                        conn.sock.settimeout(timeout)
                    conn.request(method, path, body=body, headers=headers)
                    resp = conn.getresponse()
                    content = resp.read()
                except self._STALE:
                    self._drop(key)
                    if reused and attempt == 0:
                        continue
                    raise
                except BaseException:
                    self._drop(key)
                    raise
                if resp.will_close:
                    self._drop(key)
                return HTTPResponse(resp.status, content)
        raise AssertionError("unreachable")

    def _drop(self, key) -> None:
        conn = self._conns.pop(key, None)
        if conn is not None:
            conn.close()

    def get(self, url: str, timeout: Optional[float] = None) -> HTTPResponse:
        return self._request("GET", url, None, {}, timeout)

    def post(
        self, url: str, json=None, data: Optional[bytes] = None,
        headers: Optional[Dict] = None, timeout: Optional[float] = None,
    ) -> HTTPResponse:
        headers = dict(headers or {})
        if json is not None:
            data = _json.dumps(json).encode("utf-8")
            headers.setdefault("Content-Type", "application/json")
        return self._request("POST", url, data or b"", headers, timeout)

    def close(self) -> None:
        with self._lock:
            for key in list(self._conns):
                self._drop(key)


def synthetic_frames(
    width: int = 640, height: int = 480, seed: int = 0
) -> Iterator[np.ndarray]:
    """Deterministic moving-noise source for tests/headless runs."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    i = 0
    while True:
        yield np.roll(base, shift=i * 3, axis=1)
        i += 1


class FaceRecognitionClient:
    def __init__(
        self,
        server_url: str = "http://127.0.0.1:5000",
        session_name: Optional[str] = None,
        camera_id: int = 0,
        video_path: Optional[str] = None,
        synthetic: bool = False,
        frame_skip: int = 5,
        max_frames: int = 0,
        display: bool = True,
        output_dir: str = "client_sessions",
        auto_snapshot_interval: float = 0.0,
        image_format: str = "png",
        det_size: tuple = (640, 640),
    ):
        self._session = HTTPSession()
        self.server_url = server_url.rstrip("/")
        self.session_name = session_name or datetime.now().strftime(
            "session_%Y%m%d_%H%M%S"
        )
        self.camera_id = camera_id
        self.video_path = video_path
        self.synthetic = synthetic
        self.frame_skip = max(1, frame_skip)
        self.max_frames = max_frames
        self.display = display
        self.auto_snapshot_interval = auto_snapshot_interval
        self.image_format = image_format
        self.det_size = det_size  # server canvas; raw transports letterbox here

        self.output_dir = os.path.join(output_dir, self.session_name)
        self.perf_monitor = PerformanceMonitorClient(
            session_name=self.session_name, output_dir=self.output_dir
        )

        # mirrored server state for the HUD
        self.tracks: list = []
        self.recognized_tracks: Dict = {}
        self.recognition_attempts: Dict = {}
        self.failed_tracks: Dict = {}

        self.frame_count = 0
        self._running = False
        self._last_snapshot = time.time()

    # ---------------------------------------------------------------- server

    def check_server(self) -> bool:
        try:
            r = self._session.get(f"{self.server_url}/health", timeout=5)
            return r.status_code == 200
        except Exception as e:
            print(f"Server health check failed: {e}")
            return False

    def init_session(self) -> bool:
        try:
            r = self._session.post(
                f"{self.server_url}/init_session",
                json={"session_name": self.session_name},
                timeout=10,
            )
            ok = r.status_code == 200
            if ok:
                print(f"Session initialized: {self.session_name}")
            else:
                print(f"init_session failed: {r.text}")
            return ok
        except Exception as e:
            print(f"init_session error: {e}")
            return False

    def _post_frame(self, frame_rgb: np.ndarray):
        if self.image_format in ("raw", "raw-i420"):
            # zero-decode transport: letterbox here, ship raw planes; the
            # server does a frombuffer+reshape instead of b64+imdecode
            canvas, scale = rawproto.letterbox_rgb(frame_rgb, self.det_size)
            if self.image_format == "raw-i420":
                payload, fmt = rawproto.rgb_to_i420(canvas).tobytes(), "i420"
            else:
                payload, fmt = np.ascontiguousarray(canvas).tobytes(), "rgb24"
            return self._session.post(
                f"{self.server_url}/process_frame_raw",
                data=payload,
                headers={
                    "Content-Type": "application/octet-stream",
                    rawproto.HEADER_FORMAT: fmt,
                    rawproto.HEADER_WIDTH: str(self.det_size[1]),
                    rawproto.HEADER_HEIGHT: str(self.det_size[0]),
                    rawproto.HEADER_SCALE: repr(scale),
                    rawproto.HEADER_COUNT: str(self.frame_count),
                    rawproto.HEADER_TIMESTAMP: datetime.now().isoformat(),
                },
                timeout=30,
            )
        return self._session.post(
            f"{self.server_url}/process_frame",
            json={
                "frame": _encode_image_base64(frame_rgb, self.image_format),
                "frame_count": self.frame_count,
                "timestamp": datetime.now().isoformat(),
            },
            timeout=30,
        )

    def send_frame(self, frame_rgb: np.ndarray, timings: Dict) -> Optional[Dict]:
        self.perf_monitor.mark_network_start(timings)
        try:
            r = self._post_frame(frame_rgb)
            self.perf_monitor.mark_network_end(timings)
            if r.status_code != 200:
                print(f"process_frame error {r.status_code}: {r.text[:200]}")
                return None
            return r.json()
        except Exception as e:
            self.perf_monitor.mark_network_end(timings)
            print(f"process_frame exception: {e}")
            return None

    def save_snapshot(self, frame_rgb: np.ndarray) -> None:
        try:
            self._session.post(
                f"{self.server_url}/save_snapshot",
                json={
                    "snapshot": _encode_image_base64(frame_rgb),
                    "frame_count": self.frame_count,
                    "timestamp": datetime.now().strftime("%Y%m%d_%H%M%S"),
                },
                timeout=10,
            )
        except Exception as e:
            print(f"save_snapshot error: {e}")

    def finalize_session(self) -> None:
        report = self.perf_monitor.finalize_session()
        try:
            self._session.post(
                f"{self.server_url}/finalize",
                json={"client_performance_report": report},
                timeout=30,
            )
            print("Session finalized on server")
        except Exception as e:
            print(f"finalize error: {e}")
        finally:
            self._session.close()

    # ---------------------------------------------------------------- source

    def _open_source(self):
        if self.synthetic:
            return synthetic_frames()
        import cv2

        if self.video_path:
            cap = cv2.VideoCapture(self.video_path)
        else:
            cap = cv2.VideoCapture(self.camera_id)
            # probe the resolution ladder (face_recognition_client.py:130-160)
            for w, h in RESOLUTION_LADDER:
                cap.set(cv2.CAP_PROP_FRAME_WIDTH, w)
                cap.set(cv2.CAP_PROP_FRAME_HEIGHT, h)
                if (
                    cap.get(cv2.CAP_PROP_FRAME_WIDTH) == w
                    and cap.get(cv2.CAP_PROP_FRAME_HEIGHT) == h
                ):
                    print(f"Camera resolution: {w}x{h}")
                    break
        if not cap.isOpened():
            raise RuntimeError("Could not open video source")

        def gen():
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            cap.release()

        return gen()

    # ------------------------------------------------------------------- HUD

    def _draw_display(self, frame_rgb: np.ndarray) -> np.ndarray:
        import cv2

        img = frame_rgb.copy()
        for track in self.tracks:
            tid = str(track["track_id"])
            x1, y1, x2, y2 = [int(v) for v in track["bbox"]]
            if tid in self.recognized_tracks:
                info = self.recognized_tracks[tid]
                color = (0, 255, 0)
                label = f"{info['name']} {info['confidence']:.2f}"
            elif self.failed_tracks.get(tid):
                color = (255, 0, 0)
                label = "Unknown"
            else:
                attempts = self.recognition_attempts.get(tid, 0)
                color = (255, 255, 0)
                label = f"Identifying... ({attempts})"
            cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
            cv2.putText(img, label, (x1, max(18, y1 - 6)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.6, color, 2)
        cv2.putText(
            img,
            f"frame {self.frame_count} | recognized {len(self.recognized_tracks)}",
            (8, 22), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 2,
        )
        return img

    # ------------------------------------------------------------------- run

    def process_frame(self, frame_rgb: np.ndarray) -> Optional[Dict]:
        """Send every frame_skip-th frame; update mirrored state."""
        timings = self.perf_monitor.start_frame()
        self.perf_monitor.mark_capture_end(timings)
        self.frame_count += 1

        response = None
        send = self.frame_count % self.frame_skip == 0
        if send:
            response = self.send_frame(frame_rgb, timings)
            if response:
                self.tracks = response.get("tracks", [])
                self.recognized_tracks = response.get("recognized_tracks", {})
                self.recognition_attempts = response.get("recognition_attempts", {})
                self.failed_tracks = response.get("failed_tracks", {})
                for tid, info in response.get("newly_recognized", {}).items():
                    print(
                        f"  -> recognized track {tid}: {info['name']} "
                        f"({info['confidence']:.3f})"
                    )
        self.perf_monitor.mark_detection_end(timings)
        self.perf_monitor.end_frame(
            timings,
            num_faces_detected=len(self.tracks),
            network_request_sent=send and response is not None,
        )
        if (
            self.auto_snapshot_interval > 0
            and time.time() - self._last_snapshot > self.auto_snapshot_interval
        ):
            self.save_snapshot(frame_rgb)
            self._last_snapshot = time.time()
        return response

    def run(self) -> int:
        if not self.check_server():
            print("Server is not reachable; aborting")
            return 1
        if not self.init_session():
            return 1

        self._running = True

        def _stop(signum, frame):
            self._running = False

        try:
            signal.signal(signal.SIGINT, _stop)
            signal.signal(signal.SIGTERM, _stop)
        except ValueError:
            pass  # not on the main thread

        source = self._open_source()
        try:
            for frame in source:
                if not self._running:
                    break
                self.process_frame(frame)
                if self.display:
                    import cv2

                    hud = self._draw_display(frame)
                    cv2.imshow("face recognition", cv2.cvtColor(hud, cv2.COLOR_RGB2BGR))
                    key = cv2.waitKey(1) & 0xFF
                    if key == ord("q"):
                        break
                    if key == ord("s"):
                        self.save_snapshot(frame)
                if self.max_frames and self.frame_count >= self.max_frames:
                    break
        finally:
            self.finalize_session()
            if self.display:
                try:
                    import cv2

                    cv2.destroyAllWindows()
                except Exception:
                    pass
        return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Face recognition camera client")
    p.add_argument("--server", type=str, default="http://127.0.0.1:5000")
    p.add_argument("--session_name", type=str, default=None)
    p.add_argument("--camera_id", type=int, default=0)
    p.add_argument("--video", type=str, default=None,
                   help="Process a video file instead of the camera")
    p.add_argument("--synthetic", action="store_true",
                   help="Use a synthetic frame source (headless testing)")
    p.add_argument("--frame_skip", type=int, default=5)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--no_display", action="store_true")
    p.add_argument("--output_dir", type=str, default="client_sessions")
    p.add_argument("--auto_snapshot_interval", type=float, default=0.0)
    p.add_argument("--image_format",
                   choices=("png", "jpeg", "raw", "raw-i420"), default="png",
                   help="frame payload codec; jpeg is ~10x smaller/faster than "
                        "png (the reference format); raw/raw-i420 ship "
                        "letterboxed planes with NO codec at all — the server "
                        "skips base64+imdecode entirely (raw-i420 also halves "
                        "the bytes on the wire)")
    p.add_argument("--det_size", type=str, default="640x640",
                   help="server detection canvas WxH (raw transports "
                        "letterbox client-side to this size)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    client = FaceRecognitionClient(
        server_url=args.server,
        session_name=args.session_name,
        camera_id=args.camera_id,
        video_path=args.video,
        synthetic=args.synthetic,
        frame_skip=args.frame_skip,
        max_frames=args.max_frames,
        display=not args.no_display,
        output_dir=args.output_dir,
        auto_snapshot_interval=args.auto_snapshot_interval,
        image_format=args.image_format,
        det_size=tuple(int(v) for v in reversed(args.det_size.split("x"))),
    )
    return client.run()


if __name__ == "__main__":
    raise SystemExit(main())
