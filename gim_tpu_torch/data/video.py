"""Video frame streaming (host side, cv2).

Port of `gim_tpu/data/video.py`, copied as it is: cv2.VideoCapture
seek-based access in place of the reference's torchvision VideoReader
wrapper (ref datasets/walk/video_streamer.py:7-69), fps-aware frame
listing with skip, default usable range [300 s, end - 300 s] (ref
video_preprocessor.py:82-86), and a PNG frame cache with an in-memory LRU
in front of it.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from os.path import exists, join

import numpy as np


class VideoStreamer:
    def __init__(self, path: str, margin_s: float = 300.0):
        import cv2

        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise FileNotFoundError(path)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.n_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.size = (int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                     int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        start = int(margin_s * self.fps)
        end = self.n_frames - int(margin_s * self.fps)
        if end <= start:  # short video: use everything
            start, end = 0, self.n_frames
        self.start, self.end = start, end

    def frame_indices(self, skip: int) -> list[int]:
        return list(range(self.start, self.end, skip))

    def read(self, idx: int) -> np.ndarray:
        import cv2

        self.cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, frame = self.cap.read()
        if not ok:
            raise IOError(f"frame {idx} unreadable")
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def close(self):
        self.cap.release()


class FrameCache:
    """PNG frame cache (ref datasets/walk/video_loader.py:17-65): decode
    once, reuse. A small in-memory LRU sits in front of the PNG tier:
    training epochs revisit the same few dozen frames. Cached arrays are
    never mutated by consumers (augmentors are pure; the geometric
    augmentation's slices copy on write)."""

    def __init__(self, video_path: str, cache_dir: str,
                 mem_frames: int = 256):
        self.streamer = VideoStreamer(video_path)
        self.dir = cache_dir
        self.mem_frames = mem_frames
        self._mem: OrderedDict[int, np.ndarray] = OrderedDict()
        # cv2.VideoCapture seek/read is not thread-safe: concurrent reads
        # from prefetch producers interleave packets and would poison the
        # PNG tier; the LRU's check-then-move needs a lock of its own
        self._vlock = threading.Lock()
        self._mlock = threading.Lock()
        os.makedirs(cache_dir, exist_ok=True)

    def frame(self, idx: int) -> np.ndarray:
        import cv2

        with self._mlock:
            rgb = self._mem.get(idx)
            if rgb is not None:
                self._mem.move_to_end(idx)
                return rgb
        p = join(self.dir, f"{idx}.png")
        if exists(p):
            rgb = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        else:
            with self._vlock:
                rgb = self.streamer.read(idx)
            cv2.imwrite(p, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        if self.mem_frames > 0:
            with self._mlock:
                self._mem[idx] = rgb
                while len(self._mem) > self.mem_frames:
                    self._mem.popitem(last=False)
        return rgb
