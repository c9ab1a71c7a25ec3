"""UniGR demo server: referring video QA and video segmentation over HTTP,
counterpart of `rga3_tpu/serve/app.py` (a stdlib HTTP server with a small
HTML front end; the reference's Gradio app has two tabs, QA with an
optional drawn overlay on one frame and segmentation by a teacher-forced
"Sure, [SEG]."):

  * /api/qa      - upload a video and a question (and optionally a drawn
                   key frame with its position `overlay_frac`): up to 16
                   sampled frames, greedy decode (speculative with a draft
                   model; concurrent requests coalesced into one
                   `answer_batch` when the batch window is > 0);
  * /api/segment - upload a video and an expression: per-frame masks as
                   COCO RLE.

`UniGRService` holds the models. It takes one lock around every model
call, from the handler threads and the batcher's worker alike: the port
issues all its work on one CUDA stream, and the int4 decode product's
split-sum workspace (`ops.quant`) must not be used by two calls at once.
`load_video` (default `data.video.load_frames_from_video`, which needs
OpenCV) is the one seam: a caller without OpenCV passes its own reader of
the uploaded file.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from ..data.video import load_frames_from_video
from ..utils import rle

INDEX_HTML = """<!doctype html>
<html><head><title>UniGR (rga3_tpu_torch) demo</title>
<style>
 body { font-family: sans-serif; max-width: 760px; margin: 2em auto; }
 #draw { border: 1px solid #888; max-width: 100%; cursor: crosshair;
         touch-action: none; }
 .row { margin: 0.4em 0; }
 #answer, #segout { white-space: pre-wrap; background: #f4f4f4;
                    padding: 0.6em; margin-top: 0.6em; }
</style></head>
<body>
<h2>UniGR — object-centric video QA &amp; segmentation (GPU)</h2>

<h3>Referring Video QA</h3>
<p>Upload a video, grab a frame, draw a visual prompt on it (the drawn
frame replaces the original at its position — ref app.py ImageEditor
flow), then ask.</p>
<div class="row"><input type="file" id="qavideo" accept="video/*"></div>
<div class="row">
  <input type="range" id="seek" min="0" max="1000" value="0" disabled>
  <button id="grab" disabled>Grab frame</button>
  <button id="clear" disabled>Clear drawing</button>
</div>
<div class="row">
  tool: <select id="tool">
    <option value="brush">brush</option>
    <option value="rect">rectangle</option>
    <option value="ellipse">ellipse</option>
  </select>
  color: <input type="color" id="color" value="#ff0000">
  width: <input type="number" id="width" value="6" min="1" max="40"
                style="width:4em">
</div>
<canvas id="draw" width="640" height="360" style="display:none"></canvas>
<video id="vid" style="display:none" muted playsinline></video>
<div class="row">
  <input type="text" id="question" size="60"
         placeholder="What is the object in the red circle doing?">
  <button id="ask">Ask</button>
</div>
<div id="answer"></div>

<h3>Video Segmentation</h3>
<div class="row"><input type="file" id="segvideo" accept="video/*"></div>
<div class="row">
  <input type="text" id="expression" size="60"
         placeholder="the cat on the left">
  <button id="segbtn">Segment</button>
</div>
<div id="segout"></div>

<script>
const vid = document.getElementById('vid');
const cv = document.getElementById('draw');
const ctx = cv.getContext('2d');
let frameGrabbed = false, drawn = false, baseFrame = null;
let drawing = false, sx = 0, sy = 0, snapshot = null;

document.getElementById('qavideo').onchange = (e) => {
  const f = e.target.files[0];
  if (!f) return;
  vid.src = URL.createObjectURL(f);
  vid.onloadedmetadata = () => {
    document.getElementById('seek').disabled = false;
    document.getElementById('grab').disabled = false;
    vid.currentTime = 0;
  };
  frameGrabbed = drawn = false;
  cv.style.display = 'none';
};
document.getElementById('seek').oninput = (e) => {
  if (vid.duration) vid.currentTime = vid.duration * e.target.value / 1000;
};
document.getElementById('grab').onclick = () => {
  cv.width = vid.videoWidth; cv.height = vid.videoHeight;
  ctx.drawImage(vid, 0, 0);
  baseFrame = ctx.getImageData(0, 0, cv.width, cv.height);
  cv.style.display = 'block';
  document.getElementById('clear').disabled = false;
  frameGrabbed = true; drawn = false;
};
document.getElementById('clear').onclick = () => {
  if (baseFrame) ctx.putImageData(baseFrame, 0, 0);
  drawn = false;
};
function pos(ev) {
  const r = cv.getBoundingClientRect();
  return [(ev.clientX - r.left) * cv.width / r.width,
          (ev.clientY - r.top) * cv.height / r.height];
}
function style() {
  ctx.strokeStyle = document.getElementById('color').value;
  ctx.lineWidth = +document.getElementById('width').value;
  ctx.lineCap = 'round'; ctx.lineJoin = 'round';
}
cv.addEventListener('pointerdown', (ev) => {
  if (!frameGrabbed) return;
  drawing = true; drawn = true;
  [sx, sy] = pos(ev);
  snapshot = ctx.getImageData(0, 0, cv.width, cv.height);
  style();
  if (document.getElementById('tool').value === 'brush') {
    ctx.beginPath(); ctx.moveTo(sx, sy);
  }
  cv.setPointerCapture(ev.pointerId);
});
cv.addEventListener('pointermove', (ev) => {
  if (!drawing) return;
  const [x, y] = pos(ev);
  const tool = document.getElementById('tool').value;
  if (tool === 'brush') { ctx.lineTo(x, y); ctx.stroke(); return; }
  ctx.putImageData(snapshot, 0, 0); style(); ctx.beginPath();
  if (tool === 'rect') ctx.strokeRect(sx, sy, x - sx, y - sy);
  else { ctx.ellipse((sx + x) / 2, (sy + y) / 2, Math.abs(x - sx) / 2,
                     Math.abs(y - sy) / 2, 0, 0, 2 * Math.PI);
         ctx.stroke(); }
});
cv.addEventListener('pointerup', () => { drawing = false; });

document.getElementById('ask').onclick = async () => {
  const f = document.getElementById('qavideo').files[0];
  if (!f) { alert('choose a video'); return; }
  const fd = new FormData();
  fd.append('video', f);
  fd.append('question', document.getElementById('question').value);
  if (frameGrabbed && drawn) {
    const blob = await new Promise(r => cv.toBlob(r, 'image/png'));
    fd.append('overlay', blob, 'overlay.png');
    fd.append('overlay_frac',
              vid.duration ? String(vid.currentTime / vid.duration) : '0');
  }
  document.getElementById('answer').textContent = '…thinking…';
  const resp = await fetch('/api/qa', {method: 'POST', body: fd});
  const out = await resp.json();
  document.getElementById('answer').textContent =
      out.answer || out.error || JSON.stringify(out);
};

document.getElementById('segbtn').onclick = async () => {
  const f = document.getElementById('segvideo').files[0];
  if (!f) { alert('choose a video'); return; }
  const fd = new FormData();
  fd.append('video', f);
  fd.append('expression', document.getElementById('expression').value);
  document.getElementById('segout').textContent = '…segmenting…';
  const resp = await fetch('/api/segment', {method: 'POST', body: fd});
  const out = await resp.json();
  document.getElementById('segout').textContent =
      out.error || (out.num_frames + ' frames segmented; RLE masks ' +
                    'returned (see /api/segment JSON)');
};
</script>
</body></html>
"""


class QABatcher:
    """Coalesce concurrent QA requests into one `answer_batch` call: a
    worker thread waits `window_ms` after the first request, then takes up
    to `max_batch` pending ones (a lone request goes through `answer`).
    Every /api/qa request carries a video, which `answer_batch`'s
    one-modality rule needs. `batch_sizes` records each call's size. With
    a `lock`, the worker holds it around the model call."""

    def __init__(self, chat, max_batch: int = 4, window_ms: int = 30,
                 lock: Optional[threading.Lock] = None):
        self.chat = chat
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.model_lock = lock if lock is not None else threading.Lock()
        self._lock = threading.Lock()
        self._pending: list = []
        self._wake = threading.Event()
        self._closed = False
        self.batch_sizes: list = []
        self.worker = threading.Thread(target=self._worker, daemon=True)
        self.worker.start()

    def close(self) -> None:
        """Stop the worker (and let go of the chat) once the requests that
        are waiting have their answers."""
        self._closed = True
        self._wake.set()

    def answer(self, question: str, video_frames) -> str:
        slot = {"done": threading.Event()}
        with self._lock:
            self._pending.append((question, video_frames, slot))
        self._wake.set()
        slot["done"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["answer"]

    def _worker(self):
        while True:
            self._wake.wait()
            if self._closed and not self._pending:
                return
            time.sleep(self.window_s)  # let concurrent requests gather
            with self._lock:
                batch = self._pending[:self.max_batch]
                self._pending = self._pending[self.max_batch:]
                if not self._pending:
                    self._wake.clear()
            if not batch:
                continue
            self.batch_sizes.append(len(batch))
            try:
                with self.model_lock:
                    if len(batch) == 1:
                        q, frames, _ = batch[0]
                        answers = [self.chat.answer(q, video_frames=frames)]
                    else:
                        answers = self.chat.answer_batch(
                            [q for q, _, _ in batch],
                            video_frames_list=[f for _, f, _ in batch])
                for (_, _, slot), ans in zip(batch, answers):
                    slot["answer"] = ans
                    slot["done"].set()
            except BaseException as e:
                for _, _, slot in batch:
                    slot["error"] = e
                    slot["done"].set()


class UniGRService:
    """Model-side operations, apart from HTTP (testable directly)."""

    def __init__(self, chat=None, segmentor=None, max_qa_frames: int = 16,
                 qa_batch_window_ms: int = 0, qa_max_batch: int = 4,
                 load_video: Callable = load_frames_from_video):
        self.chat = chat
        self.segmentor = segmentor
        self.max_qa_frames = max_qa_frames
        self.load_video = load_video
        # one model call at a time: one CUDA stream, one int4 split-sum workspace
        self.lock = threading.Lock()
        self.batcher = None
        if chat is not None and qa_batch_window_ms > 0 and hasattr(chat, "answer_batch"):
            self.batcher = QABatcher(chat, max_batch=qa_max_batch,
                                     window_ms=qa_batch_window_ms, lock=self.lock)

    def qa(self, video_path: str, question: str,
           overlay_frame: Optional[np.ndarray] = None,
           overlay_frac: Optional[float] = None) -> str:
        frames, _, _ = self.load_video(video_path, num_frames=self.max_qa_frames)
        if overlay_frame is not None and frames:
            # the drawn frame replaces the sampled frame at its position
            # (overlay_frac = currentTime / duration in the page)
            idx = 0
            if overlay_frac is not None:
                idx = int(round(min(max(overlay_frac, 0.0), 1.0) * (len(frames) - 1)))
            frames[idx] = overlay_frame
        if self.chat is None:
            return "(no model loaded)"
        if self.batcher is not None:
            return self.batcher.answer(question, frames)
        with self.lock:
            return self.chat.answer(question, video_frames=frames)

    def segment(self, video_path: str, expression: str) -> dict:
        frames, _, _ = self.load_video(video_path)
        if self.segmentor is None:
            return {"error": "no model loaded"}
        with self.lock:
            masks = self.segmentor.segment_video(frames, expression)
        return {"num_frames": len(frames),
                "masks": [rle.encode(m.astype(np.uint8)) for m in masks]}


def _decode_image(data: bytes) -> np.ndarray:
    """An uploaded image (the page's PNG) as RGB uint8, by OpenCV or PIL."""
    try:
        import cv2
    except ImportError:
        import io

        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("cv2 could not decode the overlay image")
    return img[:, :, ::-1].copy()  # BGR -> RGB


def _parse_multipart(handler) -> dict:
    import email
    from email import policy

    length = int(handler.headers.get("Content-Length", 0))
    ctype = handler.headers.get("Content-Type", "")
    body = handler.rfile.read(length)
    msg = email.message_from_bytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body, policy=policy.default)
    fields = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        payload = part.get_payload(decode=True)
        fields[name] = payload if part.get_filename() else payload.decode("utf-8", "replace")
    return fields


def _with_upload(data: bytes, fn):
    """fn(path) on the upload written to a temporary file, then removed."""
    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
        f.write(data)
        path = f.name
    try:
        return fn(path)
    finally:
        os.unlink(path)


def make_handler(service: UniGRService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="application/json"):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, INDEX_HTML, "text/html")
            elif self.path == "/health":
                self._send(200, json.dumps({"status": "ok"}))
            else:
                self._send(404, json.dumps({"error": "not found"}))

        def do_POST(self):
            try:
                fields = _parse_multipart(self)
                video = fields.get("video", b"")
                if self.path == "/api/qa":
                    overlay = _decode_image(fields["overlay"]) if fields.get("overlay") else None
                    frac = fields.get("overlay_frac")
                    answer = _with_upload(video, lambda vp: service.qa(
                        vp, fields.get("question", ""), overlay_frame=overlay,
                        overlay_frac=float(frac) if frac is not None else None))
                    self._send(200, json.dumps({"answer": answer}))
                elif self.path == "/api/segment":
                    out = _with_upload(video, lambda vp: service.segment(
                        vp, fields.get("expression", "")))
                    self._send(200, json.dumps(out))
                else:
                    self._send(404, json.dumps({"error": "not found"}))
            except Exception as e:  # the error goes to the client
                self._send(500, json.dumps({"error": str(e)}))

    return Handler


def serve(service: UniGRService, port: int = 7860, background: bool = False,
          host: str = "0.0.0.0"):
    """Serve on `host:port` (port 0 takes a free one: read
    `httpd.server_address`). With `background`, serve from a daemon thread
    and return the server (`shutdown()` and `server_close()` stop it)."""
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
    httpd.serve_forever()
