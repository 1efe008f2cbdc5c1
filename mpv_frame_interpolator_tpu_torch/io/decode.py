"""Host decode via an external ffmpeg process (gated: absent in this image).

The reference delegates all real decoding to FFmpeg inside the process
(video/decode/vd_lavc.c); a serving host has no business linking a decoder into
the serving binary, so the rebuild shells out: ffmpeg decodes any container/
codec and streams y4m into our pipe reader.  The decode runs in its own
process = the reference's decode-thread analog (filters/f_decoder_wrapper.c).
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Iterator

from mpv_frame_interpolator_tpu_torch.frame import NV12, VideoFrame
from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MReader
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("decode")


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def ffmpeg_source(path: str, pixfmt: str = NV12, threads: int = 0,
                  start_pts: float = 0.0) -> Iterator[VideoFrame]:
    """Decode any media file to VideoFrames through ffmpeg -> y4m pipe."""
    if not have_ffmpeg():
        raise RuntimeError(
            f"cannot open {path!r}: ffmpeg is not installed; natively "
            f"readable formats are .y4m, .yuv (raw I420), MKV/MP4/AVI "
            f"with uncompressed video, Motion-JPEG in any of those "
            f"containers or as a raw .mjpeg stream (io/jpeg.py), "
            f"Ut Video (io/utvideo.py), and FFV1 v0/1 (io/ffv1.py)")
    outfmt = "yuv420p" if pixfmt == NV12 else "yuv420p10le"
    cmd = ["ffmpeg", "-nostdin", "-loglevel", "error", "-i", path,
           "-map", "0:v:0", "-pix_fmt", outfmt, "-f", "yuv4mpegpipe", "-"]
    if threads:
        cmd[1:1] = ["-threads", str(threads)]
    log.info("spawning decoder: %s", " ".join(cmd))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            bufsize=1024 * 1024)
    try:
        yield from Y4MReader(proc.stdout, start_pts=start_pts)
    finally:
        proc.stdout.close()
        proc.wait()
